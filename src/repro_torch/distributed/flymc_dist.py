"""Distributed FlyMC: the paper's algorithm with its data sharded over ranks.

Port of :mod:`repro.distributed.flymc_dist` onto ``torch.distributed``.
Each rank of a process group is one process with one device (the ranks may
share a card); :func:`repro_torch.distributed.launch.run_ranks` starts
them. The mapping is the reference's:

  * data rows are sharded over the ranks: rank r holds rows
    ``[r·N/W, (r+1)·N/W)`` (:func:`shard_data`; N must divide by W), and
    its own z-partition, δ cache and bright buffer over them;
  * the bound's sufficient statistics are summed over the ranks ONCE at
    setup (:func:`repro_torch.core.bounds.psum_stats`), so the collapsed
    term is replicated O(D²) work a density evaluation with no collective;
  * θ, the log-density, the keys and every θ-decision are replicated: each
    density evaluation sums the shards' bright log-L̃ terms with one scalar
    SUM a chain (one all-reduce for the chain batch);
  * the z-update is shard-local, keyed ``fold_in(key_z, rank)``;
  * capacities are per shard and grow together: the overflow flag is ORed
    over the ranks, so every rank re-runs a chunk at the same doubled
    capacity, capped at the shard's row count;
  * the step's ``StepStats`` are replicated (``n_bright`` and
    ``lik_queries`` summed), so the driver, its collectors and its host
    reads run unchanged on every rank.

The collective budget, counted by :mod:`repro_torch.distributed.comm`:

===================  ======================================================
SUM × 3 a RWMH step  1 θ-proposal (the bright log-L̃ sum), 1 post-z sampler
                     refresh (the same sum at the new bright set), 1 for
                     ``(n_bright, lik_queries)`` together (the reference
                     spends 2 there, for a budget of 4)
MAX × 1 a step       the overflow flag: every rank must agree on growth or
                     the re-run protocol diverges
z-phase              none: brightness is per datum, so z-moves are
                     shard-local at any world size
===================  ======================================================

MALA and HMC add one SUM a gradient for the gradient's shard terms
(:func:`repro_torch.distributed.comm.grad_sum_across`); slice sampling
sums once a density evaluation, and its loop flags are read from the
replicated sums, so every rank makes the same trips.

:func:`chain_fleet` is the complement: each rank steps K/W whole chains on
replicated data with the same keys a single process would give them, and
the step makes no collective.
"""

from __future__ import annotations

import dataclasses

from repro_torch.api.algorithm import SamplingAlgorithm, algorithm_from_spec
from repro_torch.core import bounds as bounds_lib
from repro_torch.core import flymc
from repro_torch.core.bounds import GLMData
from repro_torch.distributed import comm


def shard_rows(n: int, world: int, rank: int) -> slice:
    """Rank ``rank``'s rows of N: ``[r·N/W, (r+1)·N/W)``."""
    if n % world:
        raise ValueError(f"N={n} rows do not divide over {world} ranks")
    m = n // world
    return slice(rank * m, (rank + 1) * m)


def shard_data(data: GLMData, group) -> GLMData:
    """This rank's shard of a whole dataset (every rank builds or holds the
    same ``data``), as contiguous tensors on the data's device. With no
    group, the data itself."""
    if group is None:
        return data
    rows = shard_rows(data.x.shape[0], comm.world_size(group),
                      comm.rank(group))
    return GLMData(*(a[rows].contiguous() for a in data))


def make_dist_flymc(bound, log_prior, group, n_global: int, **spec_kw):
    """``(spec, init_fn, step_fn, stats_fn)`` for a data-sharded chain.

    ``capacity``/``cand_capacity`` in ``spec_kw`` are PER SHARD, and
    ``backend``/``z_backend`` pick the engines as for one device: the
    kernels run shard-local. ``stats_fn(data)`` sums the shard's
    statistics over the ranks; ``init_fn(data, stats, theta0 (K, ...),
    keys (K, 2))`` and ``step_fn(data, stats, state)`` are
    :func:`repro_torch.core.flymc.init_chain_state` and ``flymc_step``
    under the spec's group.
    """
    if group is not None and n_global % comm.world_size(group):
        raise ValueError(f"N={n_global} rows do not divide over "
                         f"{comm.world_size(group)} ranks")
    spec = flymc.FlyMCSpec(bound=bound, log_prior=log_prior, group=group,
                           **spec_kw)

    def stats_fn(data):
        stats = bound.suffstats(data)
        return stats if group is None else bounds_lib.psum_stats(stats, group)

    def init_fn(data, stats, theta0, keys):
        return flymc.init_chain_state(spec, data, stats, theta0, keys)

    def step_fn(data, stats, state):
        return flymc.flymc_step(spec, data, stats, state)

    return spec, init_fn, step_fn, stats_fn


def _spec_kw_of(spec: flymc.FlyMCSpec) -> dict:
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
            if f.name not in ("bound", "log_prior", "group")}


def dist_algorithm(bound, log_prior, group, data: GLMData,
                   step_size: float = 0.1, **spec_kw) -> SamplingAlgorithm:
    """A data-sharded FlyMC chain as a :class:`SamplingAlgorithm` for
    :func:`repro_torch.api.sample`, run by every rank of ``group`` with the
    same key.

    ``data`` is this rank's shard (:func:`shard_data`). ``spec_kw`` takes
    every :class:`~repro_torch.core.flymc.FlyMCSpec` field but the group;
    capacities are per shard, and ``grow`` doubles them on every rank at
    once, capped at the shard's row count. ``init_overflow`` is ORed over
    the ranks (one MAX), so the driver's init-growth loop runs the same on
    every rank. With ``group=None`` this is the single-device algorithm.
    """
    n_local = data.x.shape[0]
    n_global = n_local * (1 if group is None else comm.world_size(group))
    spec, _, _, stats_fn = make_dist_flymc(bound, log_prior, group, n_global,
                                           **spec_kw)
    return _dist_from_spec(spec, data, stats_fn(data), step_size)


def _dist_from_spec(spec, data, stats, step_size) -> SamplingAlgorithm:
    base = algorithm_from_spec(spec, data, stats, step_size)
    if spec.group is None:
        return base
    n_local = data.x.shape[0]

    def init_overflow(state):
        return comm.any_across(state.bright.num > spec.capacity, spec.group)

    grown = []

    def grow():
        if not grown:
            grown.append(_dist_from_spec(flymc._grow(spec, n_local), data,
                                         stats, step_size))
        return grown[0]

    return dataclasses.replace(base, grow=grow if base.grow else None,
                               resize=lambda state: _resize_dist(spec, state),
                               init_overflow=init_overflow)


def chain_fleet(alg: SamplingAlgorithm, group) -> SamplingAlgorithm:
    """Shard a run's CHAIN axis over the ranks of ``group``: rank r steps
    rows ``[r·K/W, (r+1)·K/W)`` of ``sample(..., num_chains=K)``'s chains
    (their keys and initial positions, as one process would give them) on
    the data ``alg`` holds, replicated on every rank. Chains are
    independent, so the step makes no collective, and each rank's chains
    are bitwise those rows of the single-process K-chain run. Each rank's
    driver grows its own capacities; chains are capacity-invariant, so
    that changes no bit. K must divide by W.
    """
    world, rank = comm.world_size(group), comm.rank(group)

    def local_chains(num_chains: int) -> slice:
        return shard_rows(num_chains, world, rank)

    grown = []

    def grow():
        if not grown:
            grown.append(chain_fleet(alg.grow(), group))
        return grown[0]

    return dataclasses.replace(alg, local_chains=local_chains,
                               grow=grow if alg.grow is not None else None)


def run_dist_chain(bound, log_prior, group, data: GLMData, theta0, key,
                   num_iters: int, **spec_kw):
    """Sharded-chain driver over ``repro_torch.api.sample`` (one chain),
    run by every rank with the whole ``data`` and the same key. Returns
    ``(thetas, per-iteration trace dicts, total queries)``, replicated."""
    from repro_torch import api

    alg = dist_algorithm(bound, log_prior, group, shard_data(data, group),
                         **spec_kw)
    trace = api.sample(alg, key, num_iters, init_position=theta0,
                       device=data.x.device)
    st = trace.stats
    thetas = list(trace.theta[0])
    trace_dicts = [{"n_bright": int(st.n_bright[0, i]),
                    "lik_queries": int(st.lik_queries[0, i]),
                    "accept_prob": float(st.accept_prob[0, i])}
                   for i in range(num_iters)]
    return thetas, trace_dicts, trace.total_queries


def _resize_dist(spec, state):
    """The shard-local capacity change: a re-gather of each shard's δ
    buffer, no collective."""
    return flymc.resize_state(spec, state)
