"""Rank bodies for the distributed FlyMC tests (imports no JAX).

Each function runs on every rank of a group started by
:func:`repro_torch.distributed.launch.run_ranks` and returns host values
(numpy arrays, ints). ``tests/test_torch_distributed.py`` runs them with
gloo on the CPU, ``tests/test_torch_cuda.py`` with gloo over CUDA tensors.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from repro_torch import api, convert
from repro_torch import random as jr
from repro_torch.core import bounds, flymc
from repro_torch.distributed import comm
from repro_torch.distributed.flymc_dist import (chain_fleet, dist_algorithm,
                                                shard_data)


def _model(cfg):
    """The logistic model on the whole dataset with its own ξ (the
    reference's, tuned or not): bound, prior, data."""
    data = convert.glm_data(cfg["x"], cfg["t"], cfg["xi"], device=cfg["device"])
    prior = partial(bounds.gaussian_log_prior,
                    scale=cfg.get("prior_scale", 1.0))
    return bounds.LogisticBound(), prior, data


def _host(trace):
    st = trace.stats
    return {"theta": trace.theta.cpu().numpy(),
            **{f: getattr(st, f).cpu().numpy() for f in st._fields}}


def _counted_steps(alg, state, keys, steps):
    """``steps`` more steps from ``state``: the collectives a step (SUM,
    MAX) and those made inside the z-update."""
    z_made = {"sum": 0, "max": 0}
    real = {n: getattr(flymc, n) for n in ("_fused_z_update",
                                           "_implicit_z_update")}

    def wrap(fn):
        def counted(*a, **k):
            before = dict(comm.counts)
            out = fn(*a, **k)
            for op in z_made:
                z_made[op] += comm.counts[op] - before[op]
            return out
        return counted

    for n, fn in real.items():
        setattr(flymc, n, wrap(fn))
    try:
        comm.reset_counts()
        for _ in range(steps):
            state, _ = alg.step(jr.fold_in(keys, state.iteration), state)
        made = dict(comm.counts)
    finally:
        for n, fn in real.items():
            setattr(flymc, n, fn)
    return {op: made[op] / steps for op in made}, z_made


def dist_chain(group, cfg):
    """One data-sharded chain (``cfg["num_chains"]`` chains) through
    ``api.sample``: the whole run, or its first ``cfg["resume_at"]``
    iterations and a resumed rest. Returns the trace on the host, the
    grown capacity and the collectives a step of 4 more steps."""
    bound, log_prior, data = _model(cfg)
    dev = cfg["device"]
    alg = dist_algorithm(bound, log_prior, group, shard_data(data, group),
                         step_size=cfg.get("step_size", 0.1), **cfg["spec"])
    key = jr.key(cfg["seed"], device=dev)
    theta0 = (None if cfg.get("theta0") is None
              else torch.as_tensor(cfg["theta0"], device=dev))
    k, iters, chunk = cfg.get("num_chains", 1), cfg["iters"], cfg["chunk"]
    cut = cfg.get("resume_at")
    if cut is None:
        tr = api.sample(alg, key, iters, num_chains=k, chunk_size=chunk,
                        init_position=theta0, device=dev)
        out = _host(tr)
    else:
        a = api.sample(alg, key, cut, num_chains=k, chunk_size=chunk,
                       init_position=theta0, device=dev)
        # the run's step key: the chains' keys come from it as in the
        # contiguous run, and the fold-in counter goes on from the state
        tr = api.sample(a.algorithm, jr.split(key)[1], iters - cut,
                        num_chains=k, chunk_size=chunk,
                        init_state=a.final_state, device=dev)
        out = {f: np.concatenate([x, y], axis=1)
               for (f, x), y in zip(_host(a).items(), _host(tr).values())}
    per_step, z_made = _counted_steps(tr.algorithm, tr.final_state,
                                      jr.split(key, k) if k > 1 else key[None],
                                      4)
    out.update(capacity=tr.algorithm.spec.capacity, per_step=per_step,
               z_phase=z_made, rank=comm.rank(group))
    return out


def fleet_chains(group, cfg):
    """``chain_fleet`` of the kernel-engine firefly algorithm on the whole
    (replicated) dataset: this rank's rows of ``cfg["num_chains"]`` chains
    and the collectives its steps made."""
    bound, log_prior, data = _model(cfg)
    dev = cfg["device"]
    alg = chain_fleet(api.firefly(bound=bound, log_prior=log_prior,
                                  data=data, device=dev, **cfg["spec"]),
                      group)
    comm.reset_counts()
    tr = api.sample(alg, jr.key(cfg["seed"], device=dev), cfg["iters"],
                    num_chains=cfg["num_chains"], chunk_size=cfg["chunk"],
                    device=dev)
    return dict(_host(tr), collectives=dict(comm.counts))


def dist_runs(group, cfgs):
    """:func:`dist_chain` for each config, in one start of the ranks."""
    return [dist_chain(group, cfg) for cfg in cfgs]


def dist_value_and_grad(group, cfg):
    """The joint log-density and its θ-gradient with every datum bright,
    from the shards (summed over the ranks) — to hold against the whole
    dataset's on one device."""
    from repro_torch.core import brightness, samplers

    bound, log_prior, data = _model(cfg)
    shard = shard_data(data, group)
    assert all(torch.equal(a, b) for a, b in zip(shard, convert.glm_shard(
        cfg["x"], cfg["t"], cfg["xi"], comm.world_size(group),
        comm.rank(group), device=cfg["device"])))
    n = shard.x.shape[0]
    spec = flymc.FlyMCSpec(bound=bound, log_prior=log_prior, capacity=n,
                           cand_capacity=n, group=group, **cfg["spec"])
    stats = bounds.psum_stats(bound.suffstats(shard), group)
    bright = brightness.from_z(torch.ones(1, n, dtype=torch.bool,
                                          device=shard.x.device))
    idx, _ = brightness.bright_buffer(bright, n)
    f = flymc.make_joint_logpost(spec, shard, stats, idx, bright.num)
    comm.reset_counts()
    lp, _, grad = samplers.value_and_grad(
        f, torch.as_tensor(cfg["theta0"], device=shard.x.device)[None])
    return {"lp": lp.cpu().numpy(), "grad": grad.cpu().numpy(),
            "sums": comm.counts["sum"]}


def dist_step_syncs(group, cfg):
    """``cfg["steps"]`` data-sharded RWMH steps (after two warm ones)
    under ``set_sync_debug_mode("warn")``: the source lines that made the
    host wait for the card, with their counts, and the collectives made."""
    import warnings
    from collections import Counter
    from pathlib import Path

    bound, log_prior, data = _model(cfg)
    alg = dist_algorithm(bound, log_prior, group, shard_data(data, group),
                         **cfg["spec"])
    dev = data.x.device
    k_init, k_steps = jr.split(jr.key(cfg["seed"], device=dev))
    state = alg.init(k_init[None], alg.default_position[None])
    keys = k_steps[None]
    for _ in range(2):
        state, _ = alg.step(jr.fold_in(keys, state.iteration), state)
    torch.cuda.synchronize()
    comm.reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(cfg["steps"]):
                state, _ = alg.step(jr.fold_in(keys, state.iteration), state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "called a synchronizing CUDA operation"
                    in str(w.message))
    return {"sites": dict(sites), "collectives": dict(comm.counts),
            "theta": state.sampler.theta.cpu().numpy()}
