"""Chunked multi-chain sampling driver (eager).

Port of :func:`repro.api.driver.sample`. An eager Python loop takes the
place of ``jit`` + ``lax.scan``; the semantics are the reference's:

  * keys: ``k_init, k_steps = split(key)``; with K > 1 chains the chain keys
    are ``split(k_steps, K)`` (and the init keys ``split(k_init, K)``), with
    one chain the key itself; iteration ``i`` of chain k uses
    ``fold_in(chain_key_k, i)``;
  * chunks of ``chunk_size`` steps with one host sync per chunk (the
    overflow flag); collectors see only committed chunks;
  * an overflowed chunk is re-run from the saved pre-chunk state at doubled
    capacity with the same keys, so the chain is bitwise the one an
    unbounded buffer would give;
  * an initial bright set that does not fit grows the capacity and re-inits
    from the same keys;
  * ``init_state`` resumes with the fold-in counter offset by the state's
    iteration, so split runs equal one contiguous run bitwise.

The state always carries a leading chain axis, also for one chain.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import random as jr
from repro_torch.api import collectors as collectors_lib
from repro_torch.api.algorithm import SamplingAlgorithm
from repro_torch.device import resolve_device


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


def sample(
    alg: SamplingAlgorithm,
    key,
    num_samples: int,
    *,
    num_chains: int = 1,
    chunk_size: int = 128,
    init_position=None,
    init_state=None,
    collectors: dict | None = None,
    device="cuda",
) -> Trace:
    """Run ``num_samples`` iterations of ``alg`` for ``num_chains`` chains."""
    dev = resolve_device(device)
    if alg.device != dev:
        raise ValueError(f"the algorithm lives on {alg.device}, but device={dev}")
    if num_samples <= 0:
        raise ValueError("num_samples must be positive")
    if num_chains < 1:
        raise ValueError("num_chains must be >= 1")
    chunk_size = max(1, min(int(chunk_size), num_samples))
    key = key.to(dev)
    if collectors is None:
        colls = {"trace": collectors_lib.FullTrace()}
        default_path = True
    else:
        colls = collectors_lib.validate_collectors(collectors)
        default_path = False

    steps_run = inits_run = 0
    start_offset = 0
    if init_state is not None:
        state = init_state
        it = state.iteration
        if it.shape != (num_chains,):
            raise ValueError(
                f"init_state resume with num_chains={num_chains} needs a "
                f"state with a leading ({num_chains},) chain axis"
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
        k_steps = key
    else:
        ks = jr.split(key)
        k_init, k_steps = ks[0], ks[1]
        position = init_position if init_position is not None else alg.default_position
        if position is None:
            raise ValueError("no init_position given and the algorithm has no default")
        positions = _chain_positions(position, num_chains, alg.default_position)
        positions = positions.to(dev)
        init_keys = jr.split(k_init, num_chains) if num_chains > 1 else k_init[None]
        state = alg.init(init_keys, positions)
        inits_run += 1
        while alg.init_overflow is not None and bool(alg.init_overflow(state).any()):
            alg = _grown(alg)
            state = alg.init(init_keys, positions)
            inits_run += 1

    chain_keys = jr.split(k_steps, num_chains) if num_chains > 1 else k_steps[None]

    carries = None
    start = 0
    while start < num_samples:
        cs = min(chunk_size, num_samples - start)
        prev = state
        while True:
            outs = []
            overflow = torch.zeros((), dtype=torch.bool, device=dev)
            st = prev
            for j in range(cs):
                keys = jr.fold_in(chain_keys, start_offset + start + j)
                st, info = alg.step(keys, st)
                steps_run += 1
                overflow = overflow | info.overflow.any()
                outs.append((alg.position_of(st), info))
            if not bool(overflow):  # the chunk's one host sync
                break
            alg = _grown(alg)
            prev = alg.resize(prev) if alg.resize is not None else prev
        if carries is None:
            pos0, info0 = outs[0]
            carries = {n: c.init(num_samples, pos0, info0) for n, c in colls.items()}
        for pos, info in outs:
            for n, c in colls.items():
                carries[n] = c.update(carries[n], pos, info)
        state = st
        start += cs

    results = {n: colls[n].finalize(carries[n]) for n in colls}
    if default_path:
        theta, stats = results["trace"]["theta"], results["trace"]["stats"]
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


__all__ = ["Trace", "sample"]
