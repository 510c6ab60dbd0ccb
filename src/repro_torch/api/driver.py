"""Chunked multi-chain sampling driver (eager).

Port of :func:`repro.api.driver.sample`. An eager Python loop takes the
place of ``jit`` + ``lax.scan``; the semantics are the reference's:

  * keys (:func:`init_and_chain_keys`): ``k_init, k_steps = split(key)``;
    with K > 1 chains the chain keys are ``split(k_steps, K)`` (and the init
    keys ``split(k_init, K)``), with one chain the key itself; iteration
    ``i`` of chain k uses ``fold_in(chain_key_k, i)``, ``i`` read from the
    state's iteration counter on the device (:func:`run_steps`);
  * chunks of ``chunk_size`` steps with one host wait per chunk (the
    overflow flag, read together with the health flag when
    ``health_check`` is on); collectors see only committed chunks;
  * an overflowed chunk is re-run from the saved pre-chunk state at doubled
    capacity with the same keys, so the chain is bitwise the one an
    unbounded buffer would give;
  * an initial bright set that does not fit grows the capacity and re-inits
    from the same keys;
  * ``init_state`` resumes with the fold-in counter offset by the state's
    iteration, so split runs equal one contiguous run bitwise;
  * ``on_chunk`` sees a :class:`ChunkEvent` at every committed boundary and
    may stop the run there; ``thin`` keeps every thin-th θ of the default
    trace.

The state always carries a leading chain axis, also for one chain. Nothing
is compiled, so there is no counterpart of the reference's jit cache
(``driver.cached_jit``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import random as jr
from repro_torch.api import collectors as collectors_lib
from repro_torch.api.algorithm import SamplingAlgorithm
from repro_torch.core.flymc import StepStats
from repro_torch.device import resolve_device


class NonFiniteError(RuntimeError):
    """A chunk produced non-finite chain state (NaN/Inf in θ, the
    log-joint, the δ cache or the step outputs). Raised at the chunk
    boundary before the fold, so the collector carries still hold the last
    healthy committed prefix. A NaN'd proposal log-ratio compares False, so
    a poisoned chain keeps "running" while it leaves its law: it must be
    trapped, not tolerated. The serve engines run the same predicate per
    lane and quarantine just the sick lane."""


def finite_lanes(arrays, lane_axis: int = 0):
    """Per-lane all-finite mask over the floating-point tensors of
    ``arrays``, which share the axis ``lane_axis``: a lane is healthy iff
    every float entry of every tensor is finite. Other dtypes are ignored
    (counters, flags and partitions cannot go NaN). Returns a bool tensor
    over the lane axis on the tensors' device (no host wait), or None when
    no tensor is floating-point."""
    ok = None
    for a in arrays:
        if not a.is_floating_point():
            continue
        lanes = a.movedim(lane_axis, 0)
        this = torch.isfinite(lanes.reshape(lanes.shape[0], -1)).all(dim=1)
        ok = this if ok is None else (ok & this)
    return ok


class Trace(NamedTuple):
    """Everything one ``sample()`` call produced.

    theta         : (K, num_samples, ...) on the default path, else None
    stats         : StepStats of (K, num_samples) leaves, default path only
    total_queries : int total likelihood evaluations (default path, or a
                    QueryBudget collector), else None
    final_state   : chain state with a leading (K,) axis, for resuming
    algorithm     : the (possibly capacity-grown) algorithm
    results       : {name: finalized result} for ``collectors=``, else None
    steps_run     : steps executed, overflow re-runs included
    inits_run     : chain initializations executed, growth re-inits included
    """

    theta: Any
    stats: Any
    total_queries: Any
    final_state: Any
    algorithm: SamplingAlgorithm
    results: dict | None
    steps_run: int
    inits_run: int


def _chain_positions(position, num_chains: int, reference):
    """One shared position, or a (num_chains, ...) stack of them."""
    position = torch.as_tensor(position)
    if reference is not None and position.shape == reference.shape:
        return position.expand((num_chains,) + position.shape).clone()
    if position.shape[:1] == (num_chains,):
        return position
    return position.expand((num_chains,) + position.shape).clone()


def _grown(alg: SamplingAlgorithm) -> SamplingAlgorithm:
    if alg.grow is None:
        raise RuntimeError(
            "capacity overflow reported but the algorithm cannot grow "
            "(buffers already at data size)"
        )
    return alg.grow()


class ChunkEvent:
    """What ``sample``'s ``on_chunk`` sees at each committed boundary.

    ``start``/``size`` locate the chunk (``start + size`` samples are
    committed); ``num_samples`` is the run's target and ``state`` the
    post-chunk chain state. ``peek(name)`` reads the named collector's
    would-be result through :func:`repro_torch.api.collectors.peek`, which
    finalizes a clone: peeking cannot perturb the run. The carry has its
    leading (K,) chain axis, as ``finalize`` expects.
    """

    def __init__(self, start, size, num_samples, state, colls, carries):
        self.start = start
        self.size = size
        self.num_samples = num_samples
        self.state = state
        self._colls = colls
        self._carries = carries

    @property
    def committed(self) -> int:
        return self.start + self.size

    def peek(self, name: str):
        return collectors_lib.peek(self._colls[name], self._carries[name])


def split_chains(key, num_chains: int):
    """Per-chain keys (K, 2): ``split(key, K)`` for K > 1 chains, the key
    itself for one."""
    return jr.split(key, num_chains) if num_chains > 1 else key[None]


def init_and_chain_keys(key, num_chains: int):
    """The driver's key discipline: ``k_init, k_steps = split(key)``, each
    split per chain by :func:`split_chains`. Returns ``(init_keys,
    chain_keys)``. The serve engines' admission derives a job's keys here
    too, which keeps a packed job bitwise its solo run."""
    ks = jr.split(key)
    return split_chains(ks[0], num_chains), split_chains(ks[1], num_chains)


def run_steps(step, position_of, chain_keys, state, num_steps: int):
    """``num_steps`` chain-batched steps from ``state``: the chunk that
    ``sample`` and the serve engines both run. Step ``i`` of chain k keys
    with ``fold_in(chain_key_k, state.iteration)``, the iteration the chain
    has reached (init gives 0, every step adds 1; a resumed state goes on
    from its counter), read on the device: no host wait. Returns ``(final
    state, [(position, StepStats)] in step order, overflow)``, the overflow
    flag a 0-d bool tensor ORed over the steps and chains."""
    overflow = None
    outs = []
    st = state
    for _ in range(num_steps):
        st, info = step(jr.fold_in(chain_keys, st.iteration), st)
        over = info.overflow.any()
        overflow = over if overflow is None else overflow | over
        outs.append((position_of(st), info))
    return st, outs, overflow


def chunk_health(outs, state, data=None):
    """0-d bool tensor on the device: every float entry of a chunk's
    outputs, its final state and the dataset ``data`` is finite. The one
    health predicate: ``sample(health_check=True)`` raises on it and the
    serve engines quarantine a lane on it, so a lane is quarantined exactly
    when its solo run would raise. θ and the log-joint alone are not
    enough: a NaN'd dataset makes every proposal's log-ratio compare False,
    so the chain keeps "running" with finite θ while it leaves its law."""
    fields = zip(*(info for _, info in outs))
    leaves = ([torch.stack([p for p, _ in outs])]
              + [torch.stack(f) for f in fields if f[0].is_floating_point()]
              + _float_leaves(state) + _float_leaves(data))
    return torch.stack([torch.isfinite(a).all() for a in leaves
                        if a.is_floating_point()]).all()


def make_collector_fold(colls: dict, max_count: int | None = None):
    """Fold one committed chunk's outputs into the collector carries.

    The chunk outputs are the list of ``(position (K, ...), StepStats)``
    pairs of its steps, in step order; each collector's chain-batched
    ``update`` takes them one by one. The fold runs only after the chunk's
    overflow check, so an overflowed chunk never touches a carry.
    ``fold(carries, outs) -> carries``.

    With ``max_count`` the fold is the serve engines' masked form:
    ``fold(carries, count, outs) -> (carries, count)`` with ``count`` the
    host integer of samples folded so far, and updates past ``max_count``
    are skipped. A packed group runs every member the same chunk, so a job
    whose ``max_samples`` is not chunk-aligned overshoots; skipping the
    overshoot makes the carry bitwise the carry of a solo run of
    ``max_count`` samples. (The reference selects the overshoot away with a
    ``where``; the port's updates write in place, so they must not run.)
    The driver and the serve engines share this one encoding of the fold.
    """
    names = tuple(colls)

    def update(carries, pos, info):
        for n in names:
            carries[n] = colls[n].update(carries[n], pos, info)

    if max_count is None:

        def fold(carries, outs):
            for pos, info in outs:
                update(carries, pos, info)
            return carries

        return fold

    limit = int(max_count)

    def fold_masked(carries, count, outs):
        for pos, info in outs:
            if count >= limit:
                break
            update(carries, pos, info)
            count += 1
        return carries, count

    return fold_masked


def sample(
    alg: SamplingAlgorithm,
    key,
    num_samples: int,
    *,
    num_chains: int = 1,
    thin: int = 1,
    chunk_size: int = 128,
    init_position=None,
    init_state=None,
    collectors: dict | None = None,
    on_chunk=None,
    health_check: bool = False,
    device="cuda",
) -> Trace:
    """Run ``num_samples`` iterations of ``alg`` for ``num_chains`` chains.

    ``thin`` keeps every thin-th θ of the default trace (the last of each
    window; stats stay per-iteration); with ``collectors=`` use
    :class:`~repro_torch.api.collectors.ThinnedTrace`. ``on_chunk`` is
    called with a :class:`ChunkEvent` after every committed chunk; a truthy
    return stops the run at that boundary, and the Trace then holds only the
    committed samples. ``health_check`` raises :class:`NonFiniteError` at a
    boundary whose outputs or post-chunk state hold NaN/Inf, before the
    fold; its flag rides the chunk's one host read with the overflow flag.
    """
    dev = resolve_device(device)
    if alg.device != dev:
        raise ValueError(f"the algorithm lives on {alg.device}, but device={dev}")
    if num_samples <= 0:
        raise ValueError("num_samples must be positive")
    if num_chains < 1:
        raise ValueError("num_chains must be >= 1")
    if thin < 1:
        raise ValueError("thin must be >= 1")
    chunk_size = max(1, min(int(chunk_size), num_samples))
    key = key.to(dev)
    if collectors is None:
        colls = {"trace": collectors_lib.FullTrace()}
        default_path = True
    else:
        if thin != 1:
            raise ValueError(
                "thin applies to the default trace only; with collectors= "
                "use ThinnedTrace(thin) instead"
            )
        colls = collectors_lib.validate_collectors(collectors)
        default_path = False

    steps_run = inits_run = 0
    start_offset = 0
    # This process's rows of the run's chains: all of them, or a chain
    # fleet's share (the same keys as the whole run's, taken by row).
    rows = (slice(None) if alg.local_chains is None
            else alg.local_chains(num_chains))
    n_local = len(range(num_chains)[rows])
    if init_state is not None:
        state = init_state
        it = state.iteration
        if it.shape != (n_local,):
            raise ValueError(
                f"init_state resume with num_chains={num_chains} needs a "
                f"state with a leading ({n_local},) chain axis"
            )
        vals = it.tolist()
        if any(v != vals[0] for v in vals):
            raise ValueError(f"init_state chains are at different iterations {vals}")
        start_offset = int(vals[0])
        if alg.resize is not None:
            # Grow the algorithm up to the state's buffers, then resize the
            # state to the algorithm's (lossless: chains are capacity-invariant).
            c_state = state.sampler.aux.shape[1]
            while alg.grow is not None and alg.spec.capacity < c_state:
                alg = _grown(alg)
            if alg.spec.capacity != c_state:
                state = alg.resize(state)
        chain_keys = split_chains(key, num_chains)[rows]
    else:
        init_keys, chain_keys = init_and_chain_keys(key, num_chains)
        init_keys, chain_keys = init_keys[rows], chain_keys[rows]
        position = init_position if init_position is not None else alg.default_position
        if position is None:
            raise ValueError("no init_position given and the algorithm has no default")
        positions = _chain_positions(position, num_chains, alg.default_position)
        positions = positions.to(dev)[rows]
        state = alg.init(init_keys, positions)
        inits_run += 1
        while alg.init_overflow is not None and bool(alg.init_overflow(state).any()):
            alg = _grown(alg)
            state = alg.init(init_keys, positions)
            inits_run += 1

    pos0, info0 = alg.output_structs(state)
    carries = {n: c.init(num_samples, pos0, info0) for n, c in colls.items()}
    fold = make_collector_fold(colls)

    start = 0
    while start < num_samples:
        cs = min(chunk_size, num_samples - start)
        prev = state
        while True:
            st, outs, overflow = run_steps(alg.step, alg.position_of,
                                           chain_keys, prev, cs)
            steps_run += cs
            if health_check:  # one read: overflow and health together
                ok = chunk_health(outs, st, alg.data)
                over, healthy = torch.stack([overflow, ok]).tolist()
            else:
                over, healthy = bool(overflow), True  # the chunk's one host wait
            if not over:
                break
            alg = _grown(alg)
            prev = alg.resize(prev) if alg.resize is not None else prev
        if not healthy:
            raise NonFiniteError(
                f"non-finite chain state in iterations "
                f"[{start_offset + start}, {start_offset + start + cs}); "
                f"committed prefix of {start} samples is intact"
            )
        carries = fold(carries, outs)
        state = st
        start += cs
        if on_chunk is not None and on_chunk(
            ChunkEvent(start - cs, cs, num_samples, state, colls, carries)
        ):
            break
    committed = start

    results = {n: colls[n].finalize(carries[n]) for n in colls}
    if default_path:
        theta, stats = results["trace"]["theta"], results["trace"]["stats"]
        if committed < num_samples:  # on_chunk stopped the run early
            theta = theta[:, :committed]
            stats = StepStats(*(a[:, :committed] for a in stats))
        if thin > 1:
            theta = theta[:, thin - 1::thin]
        total_queries = int(stats.lik_queries.to(torch.int64).sum().item())
        results = None
    else:
        theta = stats = None
        total_queries = next(
            (results[n] for n, c in colls.items()
             if isinstance(c, collectors_lib.QueryBudget)),
            None,
        )
    return Trace(theta, stats, total_queries, state, alg, results, steps_run,
                 inits_run)


def _float_leaves(tree) -> list:
    """The floating-point tensors of a (nested NamedTuple) state."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, (tuple, list)):
        return [a for t in tree for a in _float_leaves(t)]
    return []


__all__ = [
    "ChunkEvent",
    "NonFiniteError",
    "Trace",
    "chunk_health",
    "finite_lanes",
    "init_and_chain_keys",
    "make_collector_fold",
    "run_steps",
    "sample",
    "split_chains",
]
