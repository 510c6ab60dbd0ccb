"""Firefly Monte Carlo (paper §2–§3): exact MCMC with subsets of data.

Port of :mod:`repro.core.flymc`, chain-batched: every state tensor carries a
leading ``(K, ...)`` chain axis, and each step makes one launch of each
kernel for all K chains. Every engine and mode of the reference is here:

* ``backend="pallas"`` (the default) — the θ-update's bright buffer and the
  z-update's candidates go through the fused bright-GLM kernel
  (:func:`repro_torch.kernels.bright_glm.ops.bright_glm`); the name is the
  reference's, the kernel is ``csrc/bright_glm.cu``. ``backend="jnp"``
  gathers the rows and evaluates ``bound.log_lik − bound.log_bound`` in
  plain PyTorch, so it takes any :class:`~repro_torch.core.bounds.Bound`;
* ``z_backend="fused"`` (the default) — the streamed candidate kernel
  (:func:`repro_torch.kernels.z_update.ops.z_candidates`) with per-datum
  counter uniforms and O(changed) partition updates. ``z_backend="jnp"`` is
  the reference's plain implicit engine: length-N ``jax.random`` uniforms, a
  cumsum compaction of the candidates and a partition rebuilt from z;
* ``mode="explicit"`` — Algorithm 1's Gibbs resampling of a random
  ``resample_fraction`` of the data (plain; it needs ``z_backend="jnp"``).

The reference defaults to the plain engines; the port defaults to the
kernels, which are its path on the card.

Exactness: uniforms are keyed on datum indices, the bright-GLM total is
summed in a fixed block order and every other float reduction is a
``tree_sum``, so the realized chain is bitwise independent of buffer
capacities and of how many chains run together. Capacity overflow is
flagged per step; the driver re-runs the chunk at doubled capacity.

Two extensions of the chain axis:

* **Lanes** (the sampling service's ``"vmap"`` backend). ``data`` may be a
  stack of L datasets, leaves ``(L, N, ...)``, with ``stats`` stacked the
  same way, ``(L, ...)``; the state's chain axis then holds L·K chains,
  lane-major, and chain l·K + k steps on lane l's data. Both kernels take
  the lane axis, so a step still launches each once. Nothing a chain
  computes depends on the lane stack it rides in: the collapsed term reads
  each chain's own lane's statistics by elementwise products and
  ``tree_sum``, never a batched ``@``.
* **Data shards** (:mod:`repro_torch.distributed.flymc_dist`).
  ``spec.group``, a ``torch.distributed`` process group, says that ``data``
  is this rank's shard of rows and the state's partition, δ cache and
  bright buffer are shard-local, while θ and the keys are replicated. The
  bright log-L̃ sums are summed over the ranks inside the joint, the
  z-update's key is folded with the rank, the overflow flag is ORed over
  the ranks and ``n_bright``/``lik_queries`` are summed, all through the
  counted collectives of :mod:`repro_torch.distributed.comm`. With no group
  the step makes no collective and is the single-device step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import random as jr
from repro_torch.core import brightness, samplers
from repro_torch.core.bounds import CollapsedStats, GLMData, fused_family_of
from repro_torch.core.numerics import (
    _DELTA_FLOOR,
    DRAW_BRIGHT,
    DRAW_DARKEN,
    counter_uniform,
    key_words_of,
    log_expm1,
    tree_sum,
)
from repro_torch.kernels.bright_glm.ops import bright_glm
from repro_torch.kernels.z_update.ops import z_candidates


@dataclasses.dataclass(frozen=True)
class FlyMCSpec:
    """Static configuration of a FlyMC chain."""

    bound: Any
    log_prior: Callable[[torch.Tensor], torch.Tensor]
    kernel: str = "rwmh"  # θ-operator: rwmh | mala | slice | hmc
    capacity: int = 1024  # bright-buffer capacity C
    cand_capacity: int = 1024  # dark→bright candidate buffer capacity
    q_db: float = 0.01  # dark→bright proposal probability (Alg. 2)
    mode: str = "implicit"  # z-kernel: implicit (Alg. 2) | explicit (Alg. 1)
    resample_fraction: float = 0.1  # explicit mode: fraction of data per round
    kernel_kwargs: tuple = ()
    adapt_target: float | None = None
    backend: str = "pallas"  # θ-update engine: pallas (the kernel) | jnp
    z_backend: str = "fused"  # z-update engine: fused (the kernel) | jnp
    num_warmup: int = 1000
    # torch.distributed group whose ranks hold the data shards (None: one
    # device holds all the data; the counterpart of axis_names)
    group: Any = None

    def needs_grad(self) -> bool:
        return samplers.get_kernel(self.kernel).needs_grad


class FlyMCState(NamedTuple):
    sampler: samplers.SamplerState  # θ (K, ...), lp (K,), grad, aux (K, C)
    bright: brightness.BrightState  # arr, tab (K, N) int32; num (K,)
    delta_full: torch.Tensor  # (K, N) δ at current θ (bright & just-evaluated)
    log_step: torch.Tensor  # (K,) log step size
    rng: torch.Tensor  # (K, 2) key words
    iteration: torch.Tensor  # (K,) int64


class StepStats(NamedTuple):
    n_bright: torch.Tensor  # (K,) bright count after the step
    lik_queries: torch.Tensor  # (K,) per-datum likelihood evaluations
    accept_prob: torch.Tensor  # (K,)
    overflow: torch.Tensor  # (K,) bool — re-run at larger capacity
    joint_lp: torch.Tensor  # (K,)


def _clamped(idx, n: int):
    """Gather indices clamped into [0, n), as jax's ``take`` clamps: a step
    that overflowed its buffers may leave sentinels in ``arr``; the driver
    discards it, but it must not fault before the overflow flag is read."""
    return idx.to(torch.int64).clamp(0, n - 1)


def _n_data(data: GLMData) -> int:
    """Rows of the dataset (of each lane's, for a lane stack)."""
    return data.x.shape[-2]


def _lanes(data: GLMData) -> int:
    """L for a lane stack of datasets, 0 for one dataset."""
    return data.x.shape[0] if data.x.dim() == 3 else 0


def _chain_stats(stats: CollapsedStats, data: GLMData, k: int):
    """Each of ``k`` chains' own collapsed statistics: the shared ones, or
    for a lane stack each lane's repeated over its k / L chains (a copy of
    values, so the collapsed term's bits do not depend on the stack)."""
    lanes = _lanes(data)
    if not lanes:
        return stats
    return CollapsedStats(*(a.repeat_interleave(k // lanes, dim=0)
                            for a in stats))


def _sum_bright(spec, s):
    """The bright log-L̃ sum over the data shards (one SUM all-reduce), or
    ``s`` itself on one device."""
    if spec.group is None:
        return s
    from repro_torch.distributed import comm

    return comm.sum_across(s, spec.group)


def _bright_glm(spec, data: GLMData, idx, n, theta, family):
    """The bright-GLM kernel on each chain's rows: one launch for one
    dataset or for a lane stack (chains lane-major). Returns (δ (K', C),
    total (K',))."""
    kw = spec.bound.fused_kernel_kwargs()
    lanes = _lanes(data)
    if not lanes:
        return bright_glm(data.x, data.t, data.xi, idx, n, theta,
                          family=family, **kw)
    k = idx.shape[0] // lanes
    delta, s = bright_glm(
        data.x, data.t, data.xi, idx.reshape(lanes, k, -1),
        n.reshape(lanes, k), theta.reshape((lanes, k) + theta.shape[1:]),
        family=family, **kw)
    return delta.reshape(idx.shape), s.reshape(-1)


def _family(spec: FlyMCSpec) -> str:
    fam = fused_family_of(spec.bound)
    if fam is None:
        raise ValueError(
            f"backend='pallas' needs a FusedBound, but "
            f"{type(spec.bound).__name__} has no usable fused_family hook"
        )
    return fam


def _rows_delta(bound, data: GLMData, theta, idx):
    """δ = log L − log B on each chain's gathered rows (the plain engine):
    ``idx`` (K, S) datum ids, clamped, → (K, S). Chains are evaluated one
    at a time, so a chain's δ does not depend on how many ride along; for a
    lane stack, chain k reads lane k // (K / L)."""
    i = _clamped(idx, _n_data(data))
    lanes = _lanes(data)
    per_lane = theta.shape[0] // lanes if lanes else 0
    out = []
    for k in range(theta.shape[0]):
        lane = (GLMData(*(a[k // per_lane] for a in data)) if lanes
                else data)
        rows = GLMData(lane.x[i[k]], lane.t[i[k]], lane.xi[i[k]])
        th = theta[k:k + 1]
        out.append(bound.log_lik(th, rows) - bound.log_bound(th, rows))
    return torch.cat(out)


def make_joint_logpost(spec, data: GLMData, stats: CollapsedStats,
                       bright_idx, n_bright) -> samplers.LogDensityFn:
    """f(θ) -> (joint log posterior (K,), δ on the bright buffer (K, C)).

    ``bright_idx`` (K, C) int32 slots with the first ``n_bright[k]`` valid
    (a prefix, as :func:`brightness.bright_buffer` produces); only those
    rows are evaluated, plus the O(D²) collapsed product. ``spec.backend``
    picks the fused kernel (``"pallas"``) or the plain rows (``"jnp"``).
    ``stats`` are the chains' own (:func:`_chain_stats`) for a lane stack.
    With ``spec.group`` the rows are this rank's and their sum is summed
    over the ranks (its gradient too, for MALA and HMC).
    """
    group = spec.group
    if group is not None:
        from repro_torch.distributed import comm
    if spec.backend == "pallas":
        fam = _family(spec)

        def f(theta):
            th = theta if group is None else comm.grad_sum_across(theta, group)
            delta, s = _bright_glm(spec, data, bright_idx, n_bright, th, fam)
            s = _sum_bright(spec, s)
            lp = spec.log_prior(theta) + spec.bound.collapsed(theta, stats) + s
            return lp, delta

        return f
    if spec.backend != "jnp":
        raise ValueError(
            f"unknown backend {spec.backend!r}; expected 'jnp' or 'pallas'"
        )
    slots = torch.arange(bright_idx.shape[1], device=bright_idx.device)
    mask = slots[None] < n_bright[:, None]

    def f_rows(theta):
        th = theta if group is None else comm.grad_sum_across(theta, group)
        delta = _rows_delta(spec.bound, data, th, bright_idx)
        s = tree_sum(torch.where(mask, log_expm1(delta), torch.zeros_like(delta)))
        s = _sum_bright(spec, s)
        lp = spec.log_prior(theta) + spec.bound.collapsed(theta, stats) + s
        return lp, delta

    return f_rows


def _refresh_sampler(spec, data, stats, theta, bright, delta_full):
    """Rebuild SamplerState after a z-move; gradient kernels re-evaluate
    (and pay for it). Returns (state, extra_queries (K,))."""
    idx, mask = brightness.bright_buffer(bright, spec.capacity)
    if spec.needs_grad():
        f = make_joint_logpost(spec, data, stats, idx, bright.num)
        lp, aux, grad = samplers.value_and_grad(f, theta)
        return samplers.SamplerState(theta, lp, grad, aux), bright.num
    delta = delta_full.gather(1, _clamped(idx, delta_full.shape[1]))
    s = tree_sum(torch.where(mask, log_expm1(delta), torch.zeros_like(delta)))
    s = _sum_bright(spec, s)
    lp = spec.log_prior(theta) + spec.bound.collapsed(theta, stats) + s
    return (samplers.SamplerState(theta, lp, torch.zeros_like(theta), delta),
            torch.zeros_like(bright.num))


def _candidate_delta(spec, data, theta, cand_idx, n_cand):
    """δ on the compacted candidate buffer, through the θ-update's engine."""
    if spec.backend == "pallas":
        delta, _ = _bright_glm(spec, data, cand_idx, n_cand, theta,
                               _family(spec))
        return delta
    return _rows_delta(spec.bound, data, theta, cand_idx)


def _implicit_z_update(spec, data, key, theta, bright, delta_full,
                       delta_bright):
    """Algorithm 2 by the reference's plain engine. Returns
    (z_new (K, N), delta_full, queries (K,), overflow (K,)).

    Length-N uniforms from ``split(key, 3)`` gathered by datum; the
    candidates compacted by a cumsum with padding index N, whose gathers
    clamp and whose scatters are dropped (the reference's δ there is NaN or
    garbage, masked out of everything it stores)."""
    n = _n_data(data)
    ks = jr.split(key, 3)
    k_bd, k_cand, k_db = ks[:, 0], ks[:, 1], ks[:, 2]
    dt = delta_full.dtype
    dev = delta_full.device
    z = brightness.z_of(bright)
    log_q = torch.log(torch.full((), spec.q_db, dtype=dt, device=dev))

    # --- bright → dark (free: reuses cached δ) -----------------------------
    idx_b, mask_b = brightness.bright_buffer(bright, spec.capacity)
    ib = idx_b.to(torch.int64)
    u1 = jr.uniform(k_bd, (n,)).gather(1, ib)
    darken = mask_b & (torch.log(u1) + log_expm1(delta_bright) < log_q)
    z = z.scatter(1, ib, z.gather(1, ib) & ~darken)

    # --- dark → bright (candidates pay a likelihood query each) ------------
    cap = spec.cand_capacity
    u2 = jr.uniform(k_cand, (n,))
    cand = ~brightness.z_of(bright) & (
        u2 < torch.full((), spec.q_db, dtype=dt, device=dev))
    n_cand = cand.sum(1)
    overflow_c = n_cand > cap
    pos = torch.cumsum(cand, dim=1) - 1
    scatter_to = torch.where(cand, pos, torch.full_like(pos, cap))
    ids = torch.arange(n, dtype=torch.int32, device=dev).expand_as(pos)
    cand_idx = brightness.scatter_drop(
        torch.full((z.shape[0], cap), n, dtype=torch.int32, device=dev),
        scatter_to, ids)
    mask_c = torch.arange(cap, device=dev)[None] < n_cand[:, None]
    delta_c = _candidate_delta(spec, data, theta, cand_idx,
                               torch.clamp(n_cand, max=cap))
    cand_cl = _clamped(cand_idx, n)
    u3 = jr.uniform(k_db, (n,)).gather(1, cand_cl)
    brighten = mask_c & (torch.log(u3) + log_q < log_expm1(delta_c))
    z = brightness.scatter_drop(z, cand_idx, z.gather(1, cand_cl) | brighten)
    delta_full = brightness.scatter_drop(
        delta_full, cand_idx,
        torch.where(mask_c, delta_c, delta_full.gather(1, cand_cl)))
    return z, delta_full, n_cand, overflow_c


def _fused_z_update(spec, data, key, theta, bright, delta_full, delta_bright):
    """Algorithm 2 via the fused z-engine. Returns
    (bright_new, delta_full, queries (K,), overflow (K,))."""
    n = _n_data(data)
    kw = key_words_of(key)
    # torch.full, not torch.tensor: a host scalar copied to the card would
    # make the step wait on the stream.
    log_q = torch.log(torch.full((), spec.q_db, dtype=delta_full.dtype,
                                 device=delta_full.device))

    # --- bright → dark (free: cached δ + O(C) counter uniforms) ------------
    idx_b, mask_b = brightness.bright_buffer(bright, spec.capacity)
    u1 = counter_uniform(kw, DRAW_DARKEN, idx_b)
    darken = mask_b & (torch.log(u1) + log_expm1(delta_bright) < log_q)

    # --- dark → bright (streamed selection, then O(cand) work) -------------
    cap = spec.cand_capacity
    lanes = _lanes(data)
    if lanes:  # one launch over the lanes' (K, N) blocks
        k = bright.arr.shape[0] // lanes
        cand_idx, n_cand = z_candidates(
            bright.arr.reshape(lanes, k, n), bright.num.reshape(lanes, k),
            kw.reshape(lanes, k, 2), spec.q_db, cap)
        cand_idx, n_cand = cand_idx.reshape(-1, cap), n_cand.reshape(-1)
    else:
        cand_idx, n_cand = z_candidates(bright.arr, bright.num, kw, spec.q_db,
                                        cap)
    overflow_c = n_cand > cap
    slots = torch.arange(cap, device=cand_idx.device)[None]
    mask_c = slots < n_cand[:, None]
    nb = torch.clamp(n_cand, max=cap).to(torch.int64)
    delta_c = _candidate_delta(spec, data, theta, cand_idx, nb)
    cand_cl = _clamped(cand_idx, n)
    u3 = counter_uniform(kw, DRAW_BRIGHT, cand_cl)
    brighten = mask_c & (torch.log(u3) + log_q < log_expm1(delta_c))
    old = delta_full.gather(1, cand_cl)
    delta_full = brightness.scatter_drop(
        delta_full, cand_idx, torch.where(mask_c, delta_c, old)
    )
    bright_new = brightness.apply_flips(bright, darken, cand_idx, brighten)
    return bright_new, delta_full, n_cand.to(torch.int64), overflow_c


def _explicit_z_update(spec, data, key, theta, bright, delta_full):
    """Algorithm 1 lines 3–6: Gibbs resampling of a random subset of
    ``r = max(1, round(N·resample_fraction))`` data, drawn without
    replacement (a permutation slice: its scatters never collide).
    Returns (z_new (K, N), delta_full, queries (K,), overflow (K,))."""
    n = _n_data(data)
    r = max(1, int(round(n * spec.resample_fraction)))
    ks = jr.split(key)
    k_idx, k_z = ks[:, 0], ks[:, 1]
    idx = jr.permutation(k_idx, n)[:, :r].to(torch.int64)
    delta = _rows_delta(spec.bound, data, theta, idx)
    # p(z=1) = (L-B)/L = -expm1(-δ)
    p_bright = -torch.expm1(-torch.clamp(delta, min=_DELTA_FLOOR))
    z_idx = jr.uniform(k_z, (r,)) < p_bright
    z = brightness.z_of(bright).scatter(1, idx, z_idx)
    delta_full = delta_full.scatter(1, idx, delta)
    queries = torch.full_like(bright.num, r)
    return z, delta_full, queries, torch.zeros_like(queries, dtype=torch.bool)


def flymc_step(spec, data: GLMData, stats: CollapsedStats,
               state: FlyMCState) -> tuple[FlyMCState, StepStats]:
    """θ-update followed by z-update (paper §2 alternation), K chains.

    With ``spec.group`` (data shards): the θ-kernel runs replicated with
    the same keys on every rank, and its densities sum the shards' bright
    terms, so every rank takes the same decisions; the z-update's key is
    folded with the rank, so the shards' per-datum draws are independent,
    and it makes no collective. Then one MAX for the overflow flag and one
    SUM for ``(n_bright, lik_queries)``: 3 SUM and 1 MAX a RWMH step.
    """
    ks = jr.split(state.rng, 3)
    key_theta, key_z, key_next = ks[:, 0], ks[:, 1], ks[:, 2]
    group = spec.group
    if group is not None:
        from repro_torch.distributed import comm

        key_z = jr.fold_in(key_z, comm.rank(group))
    stats = _chain_stats(stats, data, state.log_step.shape[0])

    # ---- θ | z -------------------------------------------------------------
    idx, mask = brightness.bright_buffer(state.bright, spec.capacity)
    f = make_joint_logpost(spec, data, stats, idx, state.bright.num)
    kernel = samplers.bind(spec.kernel, f, spec.kernel_kwargs)
    new_sampler, info = kernel(key_theta, state.sampler, torch.exp(state.log_step))
    queries_theta = info.n_evals * state.bright.num
    old = state.delta_full.gather(1, _clamped(idx, state.delta_full.shape[1]))
    delta_full = brightness.scatter_drop(
        state.delta_full, idx, torch.where(mask, new_sampler.aux, old)
    )

    # ---- z | θ -------------------------------------------------------------
    if spec.mode == "implicit" and spec.z_backend == "fused":
        bright_new, delta_full, queries_z, overflow_c = _fused_z_update(
            spec, data, key_z, new_sampler.theta, state.bright, delta_full,
            new_sampler.aux,
        )
    elif spec.mode == "implicit":
        z_new, delta_full, queries_z, overflow_c = _implicit_z_update(
            spec, data, key_z, new_sampler.theta, state.bright, delta_full,
            new_sampler.aux,
        )
        bright_new = brightness.from_z(z_new)
    elif spec.z_backend == "fused":
        raise ValueError(
            "z_backend='fused' requires mode='implicit' (Algorithm 1's "
            "explicit Gibbs resampling re-evaluates a dense subset, so "
            "there is no sparse candidate stream to fuse)"
        )
    else:
        z_new, delta_full, queries_z, overflow_c = _explicit_z_update(
            spec, data, key_z, new_sampler.theta, state.bright, delta_full
        )
        bright_new = brightness.from_z(z_new)
    overflow = overflow_c | (bright_new.num > spec.capacity)
    if group is not None:
        overflow = comm.any_across(overflow, group)
    refreshed, extra_q = _refresh_sampler(
        spec, data, stats, new_sampler.theta, bright_new, delta_full
    )

    log_step = state.log_step
    if spec.adapt_target is not None:
        # Warmup-only: after num_warmup iterations the kernel is fixed.
        adapted = samplers.adapt_step_size(
            log_step, info.accept_prob, spec.adapt_target, state.iteration
        )
        log_step = torch.where(state.iteration < spec.num_warmup, adapted,
                               log_step)

    new_state = FlyMCState(
        sampler=refreshed,
        bright=bright_new,
        delta_full=delta_full,
        log_step=log_step,
        rng=key_next,
        iteration=state.iteration + 1,
    )
    n_bright = bright_new.num
    lik_queries = queries_theta + queries_z + extra_q
    if group is not None:  # one SUM for both counts
        n_bright, lik_queries = comm.all_reduce_sum(
            torch.stack([n_bright, lik_queries.to(n_bright.dtype)]), group)
    stats_out = StepStats(
        n_bright=n_bright,
        lik_queries=lik_queries,
        accept_prob=info.accept_prob,
        overflow=overflow,
        joint_lp=refreshed.lp,
    )
    return new_state, stats_out


def init_chain_state(spec, data: GLMData, stats: CollapsedStats, theta0,
                     key, z0=None, step_size: float = 0.1) -> FlyMCState:
    """Chain initialization for K chains: ``theta0`` (K, ...), ``key``
    (K, 2). No host syncs and no growth: if a chain's initial bright set
    exceeds ``spec.capacity`` the δ buffer is truncated, and the caller
    rebuilds at a grown capacity from the same keys. With ``spec.group``
    the initial partition's key is folded with the rank, as the step's
    z-key is."""
    n = _n_data(data)
    ks = jr.split(key)
    k_z, k_chain = ks[:, 0], ks[:, 1]
    if spec.group is not None:
        from repro_torch.distributed import comm

        k_z = jr.fold_in(k_z, comm.rank(spec.group))
    stats = _chain_stats(stats, data, theta0.shape[0])
    if z0 is None:
        z0 = jr.bernoulli(k_z, min(2.0 * spec.q_db, 1.0), (n,))
    bright = brightness.from_z(z0)
    idx, mask = brightness.bright_buffer(bright, spec.capacity)
    f = make_joint_logpost(spec, data, stats, idx, bright.num)
    sampler = samplers.init_state(f, theta0, with_grad=spec.needs_grad())
    k = theta0.shape[0]
    delta_full = torch.zeros(k, n, dtype=sampler.lp.dtype,
                             device=theta0.device).scatter(
        1, idx.to(torch.int64),
        torch.where(mask, sampler.aux, torch.zeros_like(sampler.aux)),
    )
    log_step = torch.log(torch.full((k,), step_size, dtype=sampler.lp.dtype,
                                    device=theta0.device))
    return FlyMCState(
        sampler=sampler,
        bright=bright,
        delta_full=delta_full,
        log_step=log_step,
        rng=k_chain,
        iteration=torch.zeros(k, dtype=torch.int64, device=theta0.device),
    )


def init_chain(spec, data: GLMData, stats: CollapsedStats, theta0, key,
               z0=None, step_size: float = 0.1):
    """Deprecated host-side init of one chain; prefer ``api.firefly`` and
    ``api.sample``, which initialize internally.

    ``theta0`` is one θ and ``key`` one (2,) key; the state has the port's
    leading chain axis of 1. Returns (state, setup likelihood queries,
    spec), the spec grown until the initial bright set fits (one host read
    a try)."""
    n = _n_data(data)
    theta0, key = theta0[None], key[None]
    z0 = None if z0 is None else z0[None]
    state = init_chain_state(spec, data, stats, theta0, key, z0, step_size)
    while int(state.bright.num[0]) > spec.capacity:
        spec = _grow(spec, n)
        state = init_chain_state(spec, data, stats, theta0, key, z0, step_size)
    return state, int(state.bright.num[0]), spec


def run_chain(spec, data: GLMData, stats: CollapsedStats, state: FlyMCState,
              num_iters: int, collect: Callable[[FlyMCState], Any] | None = None):
    """Deprecated shim over the driver (``repro_torch.api.sample``) for one
    chain (a state with a chain axis of 1, as :func:`init_chain` gives).

    Returns the old shape: (samples, per-iteration trace dicts, total
    queries, the possibly grown spec). The key is the state's ``rng``, and
    the fold-in counter continues from the state's iteration, so a resumed
    segment never replays the prefix's keys. A custom ``collect`` needs the
    state after every step, so that path is a host loop with one read a
    step; it keys and grows exactly as the driver does.
    """
    from repro_torch import api  # api is built on this module

    alg = api.algorithm_from_spec(spec, data, stats)
    key = state.rng[0]
    if collect is not None:
        return _run_chain_host(alg, key, state, num_iters, collect)
    trace = api.sample(alg, key, num_iters, init_state=state,
                       device=alg.device)
    st = trace.stats
    samples = list(trace.theta[0])
    trace_dicts = [
        {"n_bright": int(st.n_bright[0, i]),
         "lik_queries": int(st.lik_queries[0, i]),
         "accept_prob": float(st.accept_prob[0, i]),
         "joint_lp": float(st.joint_lp[0, i])}
        for i in range(num_iters)
    ]
    return samples, trace_dicts, trace.total_queries, trace.algorithm.spec


def _run_chain_host(alg, key, state: FlyMCState, num_iters: int, collect):
    """``run_chain(collect=...)``: a host loop, one read a step."""
    samples, trace = [], []
    total_queries = 0
    offset = int(state.iteration[0])
    chain_key = key[None]
    for i in range(offset, offset + num_iters):
        prev = state
        new_state, st = alg.step(jr.fold_in(chain_key, i), state)
        while bool(st.overflow.any()):
            alg = alg.grow()
            prev = alg.resize(prev)
            new_state, st = alg.step(jr.fold_in(chain_key, i), prev)
        state = new_state
        total_queries += int(st.lik_queries[0])
        samples.append(collect(state))
        trace.append({"n_bright": int(st.n_bright[0]),
                      "lik_queries": int(st.lik_queries[0]),
                      "accept_prob": float(st.accept_prob[0]),
                      "joint_lp": float(st.joint_lp[0])})
    return samples, trace, total_queries, alg.spec


def _grow(spec: FlyMCSpec, n: int) -> FlyMCSpec:
    return dataclasses.replace(
        spec,
        capacity=min(2 * spec.capacity, n),
        cand_capacity=min(2 * spec.cand_capacity, n),
    )


def resize_state(spec: FlyMCSpec, state: FlyMCState) -> FlyMCState:
    """Re-gather the capacity-shaped δ buffer after a capacity change: zero
    likelihood queries, bitwise-identical chain."""
    idx, _ = brightness.bright_buffer(state.bright, spec.capacity)
    aux = state.delta_full.gather(1, _clamped(idx, state.delta_full.shape[1]))
    return state._replace(sampler=state.sampler._replace(aux=aux))
