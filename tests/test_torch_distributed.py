"""Data-sharded FlyMC and chain fleets on ``torch.distributed`` (gloo, CPU).

Against the reference: :func:`repro.distributed.flymc_dist.dist_algorithm`
on 4 emulated CPU devices (a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and the port's
:func:`repro_torch.distributed.flymc_dist.dist_algorithm` on 4 gloo ranks
(processes), from the same data, keys and start: equal accept decisions,
equal ``n_bright`` and ``lik_queries`` every step, θ within 1e-5 of its
largest value (the packages' normals differ by a few ulps, and the shard
sums meet in another order), for RWMH on the plain and on the kernel
engines and for slice sampling. Every rank's trace is bitwise rank 0's.

Within the port, bitwise: capacity invariance (a run that grows from
capacity 2 equals one at 32), a resumed run equals the contiguous one,
and ``chain_fleet`` on 2 ranks equals the single-process 4-chain run. The
collective budget is counted: 3 SUM and 1 MAX all-reduces a RWMH step,
none in the z-phase. With no group the algorithm is the single-device
one; a sharded density's gradient is the whole dataset's.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from repro_torch import api
from repro_torch import random as jr
from repro_torch.distributed.flymc_dist import (dist_algorithm,
                                                run_dist_chain, shard_data,
                                                shard_rows)
from repro_torch.distributed.launch import run_ranks, single_rank

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
N, D, W = 512, 4, 4
THETA_TOL = 1e-5
ITERS, CHUNK = 30, 10
RUNS = {  # name: (spec, iterations)
    "plain": (dict(kernel="rwmh", capacity=32, cand_capacity=32, q_db=0.05,
                   backend="jnp", z_backend="jnp"), ITERS),
    "kernels": (dict(kernel="rwmh", capacity=32, cand_capacity=32, q_db=0.05,
                     backend="pallas", z_backend="fused"), ITERS),
    "slice": (dict(kernel="slice", capacity=32, cand_capacity=32, q_db=0.05,
                   backend="pallas", z_backend="fused"), 2),
}

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro import api
    from repro.data import logistic_data
    from repro.distributed.flymc_dist import dist_algorithm, shard_data
    from repro.models.bayes_glm import GLMModel
    runs = eval(sys.argv[2])
    assert jax.device_count() == 4
    mesh = jax.make_mesh((4,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    data = logistic_data(jax.random.key(0), n=%d, d=%d, separation=1.5)
    model = GLMModel.logistic(data, prior_scale=2.0, xi=1.5)
    tuned = model.map_tuned(model.map_estimate(jax.random.key(1), steps=200))
    d = jax.device_get(tuned.data)
    out = {"x": np.asarray(d.x), "t": np.asarray(d.t), "xi": np.asarray(d.xi)}
    for name, (spec, iters) in runs.items():
        alg = dist_algorithm(tuned.bound, tuned.log_prior, mesh,
                             shard_data(tuned.data, mesh), **spec)
        tr = api.sample(alg, jax.random.key(7), iters, chunk_size=%d)
        out[name + ".theta"] = np.asarray(tr.theta)
        for f in tr.stats._fields:
            out[name + "." + f] = np.asarray(getattr(tr.stats, f))
    np.savez(sys.argv[1], **out)
""") % (N, D, CHUNK)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _REFERENCE, str(path), repr(RUNS)],
                   check=True, env=env, timeout=600, cwd=ROOT)
    with np.load(path) as z:
        return dict(z)


def _cfg(ref, spec, iters, **kw):
    return dict(x=ref["x"], t=ref["t"], xi=ref["xi"], prior_scale=2.0,
                spec=spec, seed=7, iters=iters, chunk=CHUNK, device=CPU, **kw)


# the configs of the one 4-rank start: the reference's runs, then the port's
# own contracts (capacity invariance, resume)
_OWN = {"grown": dict(RUNS["kernels"][0], capacity=2, cand_capacity=2),
        "resumed": RUNS["kernels"][0]}


@pytest.fixture(scope="module")
def port4(reference):
    cfgs = [_cfg(reference, spec, iters) for spec, iters in RUNS.values()]
    cfgs.append(_cfg(reference, _OWN["grown"], ITERS))
    cfgs.append(_cfg(reference, _OWN["resumed"], ITERS, resume_at=13))
    out = run_ranks(ranks.dist_runs, W, backend="gloo", device=CPU,
                    args=(cfgs,), timeout_s=300)
    names = list(RUNS) + list(_OWN)
    return [dict(zip(names, per_rank)) for per_rank in out]


def _moved(theta, theta0):
    prev = np.concatenate([theta0[:, None], theta[:, :-1]], axis=1)
    return np.any(theta != prev, axis=-1)


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in
               ("theta", "n_bright", "lik_queries", "accept_prob",
                "joint_lp", "overflow"))


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_chain_matches_the_reference_on_4_ranks(reference, port4,
                                                        name):
    got = port4[0][name]
    for r in range(1, W):  # replicated: every rank holds the same chain
        assert _same(port4[r][name], got)
    ref_theta = reference[name + ".theta"]
    assert got["theta"].shape == ref_theta.shape
    theta0 = np.zeros((1, D), np.float32)
    np.testing.assert_array_equal(_moved(got["theta"], theta0),
                                  _moved(ref_theta, theta0))
    for f in ("n_bright", "lik_queries"):
        np.testing.assert_array_equal(got[f], reference[f"{name}.{f}"],
                                      err_msg=f)
    np.testing.assert_allclose(got["theta"], ref_theta, rtol=0,
                               atol=THETA_TOL * np.abs(ref_theta).max())
    if name != "slice":  # the chain moves and its bright set changes
        assert _moved(got["theta"], theta0).any()
        assert got["n_bright"].min() != got["n_bright"].max()


def test_collective_budget_is_counted(port4):
    """A RWMH step: 3 SUM (proposal, refresh, the two counts together) and
    1 MAX (overflow) all-reduces, within the reference's 4 + 1; the
    z-update makes none, on either engine pair."""
    for name in ("plain", "kernels"):
        for r in range(W):
            got = port4[r][name]
            assert got["per_step"] == {"sum": 3.0, "max": 1.0}, name
            assert got["z_phase"] == {"sum": 0, "max": 0}, name
    # slice: one SUM a density evaluation, still none in the z-phase
    assert port4[0]["slice"]["z_phase"] == {"sum": 0, "max": 0}
    assert port4[0]["slice"]["per_step"]["max"] == 1.0


def test_sharded_chain_is_capacity_invariant_and_resumes_bitwise(port4):
    grown, ref = port4[0]["grown"], port4[0]["kernels"]
    assert grown["capacity"] > 2  # it grew, on every rank alike
    assert all(port4[r]["grown"]["capacity"] == grown["capacity"]
               for r in range(W))
    assert _same(grown, ref)
    assert _same(port4[0]["resumed"], ref)


def test_chain_fleet_on_2_ranks_is_the_single_process_run(reference):
    """4 chains over 2 ranks (2 each) on the kernel engines: each rank's
    rows bitwise the single-process 4-chain run, and no collective."""
    spec = dict(kernel="rwmh", capacity=4, cand_capacity=4, q_db=0.05,
                step_size=0.2)
    cfg = _cfg(reference, spec, 20, num_chains=4)
    out = run_ranks(ranks.fleet_chains, 2, backend="gloo", device=CPU,
                    args=(cfg,), timeout_s=300)
    bound, prior, data = ranks._model(cfg)
    alg = api.firefly(bound=bound, log_prior=prior, data=data, device=CPU,
                      **spec)
    tr = api.sample(alg, jr.key(7, device=CPU), 20, num_chains=4,
                    chunk_size=CHUNK, device=CPU)
    whole = ranks._host(tr)
    for r, got in enumerate(out):
        rows = shard_rows(4, 2, r)
        assert got["collectives"] == {"sum": 0, "max": 0}
        for f, a in whole.items():
            np.testing.assert_array_equal(got[f], a[rows], err_msg=f)


def test_no_group_is_the_single_device_algorithm(reference):
    """``dist_algorithm`` with no group and the whole data is bitwise
    ``api.firefly``; a group of one rank (gloo, this process) runs the
    step with its collectives counted, 3 SUM and 1 MAX a step, and
    ``run_dist_chain`` gives that chain as its lists."""
    cfg = _cfg(reference, RUNS["kernels"][0], 12)
    bound, prior, data = ranks._model(cfg)
    key = jr.key(7, device=CPU)
    a = api.sample(dist_algorithm(bound, prior, None, data, **cfg["spec"]),
                   key, 12, chunk_size=CHUNK, device=CPU)
    b = api.sample(api.firefly(bound=bound, log_prior=prior, data=data,
                               device=CPU, **cfg["spec"]),
                   key, 12, chunk_size=CHUNK, device=CPU)
    assert _same(ranks._host(a), ranks._host(b))
    assert shard_data(data, None) is data
    with single_rank("gloo", CPU) as group:
        one = ranks.dist_chain(group, cfg)
        thetas, trace, total = run_dist_chain(
            bound, prior, group, data, torch.zeros(D), key, 12, **cfg["spec"])
    assert one["per_step"] == {"sum": 3.0, "max": 1.0}
    assert one["theta"].shape == (1, 12, D) and np.isfinite(one["theta"]).all()
    # the shim over the same sharded algorithm: the same chain, as lists
    np.testing.assert_array_equal(np.stack([t.numpy() for t in thetas]),
                                  one["theta"][0])
    assert [t["n_bright"] for t in trace] == one["n_bright"][0].tolist()
    assert total == int(one["lik_queries"].sum())


def test_sharded_gradient_is_the_whole_datasets(reference):
    """With every datum bright, the log-density and its θ-gradient from 2
    shards (the bright sum and the gradient's shard terms each summed over
    the ranks) equal the whole dataset's on one process, to f32 rounding;
    a value and gradient is 2 SUM all-reduces."""
    theta0 = np.array([0.3, -0.2, 0.5, 0.1], np.float32)
    cfg = _cfg(reference, dict(kernel="mala", backend="pallas",
                               z_backend="fused"), 0, theta0=theta0)
    out = run_ranks(ranks.dist_value_and_grad, 2, backend="gloo",
                    device=CPU, args=(cfg,), timeout_s=300)
    from repro_torch.core import brightness, flymc, samplers

    bound, prior, data = ranks._model(cfg)
    spec = flymc.FlyMCSpec(bound=bound, log_prior=prior, capacity=N,
                           cand_capacity=N, **cfg["spec"])
    bright = brightness.from_z(torch.ones(1, N, dtype=torch.bool))
    idx, _ = brightness.bright_buffer(bright, N)
    f = flymc.make_joint_logpost(spec, data, bound.suffstats(data), idx,
                                 bright.num)
    lp, _, grad = samplers.value_and_grad(f, torch.as_tensor(theta0)[None])
    for got in out:
        assert got["sums"] == 2
        np.testing.assert_array_equal(got["lp"], out[0]["lp"])
        np.testing.assert_allclose(got["lp"], lp.numpy(), rtol=1e-5)
        np.testing.assert_allclose(got["grad"], grad.numpy(), rtol=1e-4,
                                   atol=1e-4 * np.abs(grad.numpy()).max())
    with pytest.raises(ValueError, match="divide"):
        shard_rows(10, 4, 0)
