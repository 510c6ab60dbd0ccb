"""Port parity for the FlyMC main path: one step from a shared state, the
chain law of a whole sampling run, and the exactness contracts of the port's
own driver (capacity, overflow re-run, chunking, chain batching, resume).

The JAX side runs its kernel engines (``backend="pallas"``,
``z_backend="fused"``) in interpret mode for the step parity; the whole-run
comparison uses its default engines, which follow the same law.
"""

import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import flymc as jflymc
from repro.data import logistic_data as jax_logistic_data
from repro.data import softmax_data as jax_softmax_data
from repro.models.bayes_glm import GLMModel as JGLMModel
from repro_torch import api, convert
from repro_torch import random as jr
from repro_torch.core import bounds as tbounds
from repro_torch.core import brightness, diagnostics
from repro_torch.core import flymc as tflymc
from repro_torch.data import logistic_data
from repro_torch.models.bayes_glm import GLMModel

CPU = "cpu"


# ---------------------------------------------------------------------------
# Step parity
# ---------------------------------------------------------------------------


def _jax_problem(family):
    if family == "logistic":
        data = jax_logistic_data(jax.random.key(0), n=900, d=6)
        model = JGLMModel.logistic(data)
    else:
        data = jax_softmax_data(jax.random.key(0), n=900, d=6, k=3)
        model = JGLMModel.softmax(data, n_classes=3)
    th = model.map_estimate(jax.random.key(1), steps=150)
    return model.map_tuned(th), th


def _log_ratio_margin(spec, model, state):
    """|log u - log_ratio| of the θ accept decision of the next JAX step."""
    key_theta = jax.random.split(state.rng, 3)[0]
    k_prop, k_acc = jax.random.split(key_theta)
    from repro.core import brightness as jb

    idx, mask = jb.bright_buffer(state.bright, spec.capacity)
    f = jflymc.make_joint_logpost(spec, model.data, model.stats, idx, mask)
    eps = jnp.exp(state.log_step)
    th = state.sampler.theta
    noise = jax.random.normal(k_prop, th.shape, th.dtype)
    if spec.kernel == "rwmh":
        th_p = th + eps * noise
        log_ratio = f(th_p)[0] - state.sampler.lp
    else:
        mean_fwd = th + 0.5 * eps * eps * state.sampler.grad
        th_p = mean_fwd + eps * noise
        (lp_p, _), g_p = jax.value_and_grad(f, has_aux=True)(th_p)
        mean_rev = th_p + 0.5 * eps * eps * g_p
        q = lambda a, m: -jnp.sum(jnp.square(a - m)) / (2.0 * eps * eps)
        log_ratio = (lp_p - state.sampler.lp) + (q(th, mean_rev) - q(th_p, mean_fwd))
    log_u = jnp.log(jax.random.uniform(k_acc, (), th.dtype))
    return jnp.abs(log_u - log_ratio)


def _to_port(state):
    s = jax.device_get(state)
    return dict(
        theta=s.sampler.theta, lp=s.sampler.lp, grad=s.sampler.grad,
        aux=s.sampler.aux, arr=s.bright.arr, tab=s.bright.tab, num=s.bright.num,
        delta_full=s.delta_full, log_step=s.log_step,
        rng=np.asarray(jax.random.key_data(state.rng)), iteration=s.iteration,
    )


@pytest.mark.parametrize("family,kernel,step", [
    ("logistic", "rwmh", 0.05), ("softmax", "mala", 0.02),
])
def test_one_step_matches_jax_kernel_engines(family, kernel, step):
    model, th_map = _jax_problem(family)
    spec = jflymc.FlyMCSpec(
        bound=model.bound, log_prior=model.log_prior, kernel=kernel,
        capacity=128, cand_capacity=64, q_db=0.02, backend="pallas",
        z_backend="fused",
    )
    init = jax.jit(lambda k: jflymc.init_chain_state(
        spec, model.data, model.stats, th_map, k, step_size=step))
    step_fn = jax.jit(lambda st: jflymc.flymc_step(spec, model.data,
                                                   model.stats, st))
    margin = jax.jit(lambda st: _log_ratio_margin(spec, model, st))
    states, outs, margins = [], [], []
    for seed in (3, 4):  # two chains, batched in the port
        st = init(jax.random.key(seed))
        margins.append(float(margin(st)))
        states.append(_to_port(st))
        outs.append(step_fn(st))
    assert min(margins) > 1e-4, margins  # decisions are not knife-edge

    d = jax.device_get(model.data)
    tdata = convert.glm_data(d.x, d.t, d.xi, device=CPU)
    tstats = convert.collapsed_stats(*jax.device_get(model.stats), device=CPU)
    bound = (tbounds.LogisticBound() if family == "logistic"
             else tbounds.SoftmaxBound())
    tspec = tflymc.FlyMCSpec(
        bound=bound, log_prior=partial(tbounds.gaussian_log_prior, scale=1.0),
        kernel=kernel, capacity=128, cand_capacity=64, q_db=0.02,
    )
    batched = {k: np.stack([s[k] for s in states]) for k in states[0]}
    tstate = convert.flymc_state(**batched, device=CPU, batched=True)
    new, stats = tflymc.flymc_step(tspec, tdata, tstats, tstate)

    for i, (ref, ref_stats) in enumerate(outs):
        ref = jax.device_get(ref)
        np.testing.assert_array_equal(new.bright.arr[i].numpy(), ref.bright.arr)
        np.testing.assert_array_equal(new.bright.tab[i].numpy(), ref.bright.tab)
        assert int(new.bright.num[i]) == int(ref.bright.num)
        np.testing.assert_allclose(new.sampler.theta[i].numpy(), ref.sampler.theta,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(new.delta_full[i].numpy(), ref.delta_full,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(new.rng[i].numpy(),
                                      np.asarray(jax.random.key_data(ref.rng)))
        assert int(stats.lik_queries[i]) == int(ref_stats.lik_queries)
        assert bool(stats.overflow[i]) == bool(ref_stats.overflow)


# ---------------------------------------------------------------------------
# Exactness contracts within the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tuned():
    data = logistic_data(jr.key(0, device=CPU), n=600, d=5, device=CPU)
    model = GLMModel.logistic(data, device=CPU)
    return model.map_tuned(model.map_estimate(jr.key(1, device=CPU), steps=150))


def _alg(model, cap, cand=None):
    return api.firefly(model, kernel="rwmh", capacity=cap,
                       cand_capacity=cand or cap, q_db=0.02, step_size=0.05,
                       adapt_target="auto", num_warmup=20, device=CPU)


def test_capacity_and_overflow_rerun_are_bitwise_exact(tuned):
    big = api.sample(_alg(tuned, 256), jr.key(7, device=CPU), 40, num_chains=2,
                     device=CPU)
    small = api.sample(_alg(tuned, 8), jr.key(7, device=CPU), 40, num_chains=2,
                       chunk_size=10, device=CPU)
    assert small.algorithm.spec.capacity > 8  # it overflowed and grew
    assert small.steps_run > 40 and small.inits_run > 1
    assert torch.equal(big.theta, small.theta)
    for a, b in zip(big.stats, small.stats):
        assert torch.equal(a, b)


def test_chunk_size_does_not_change_the_chain(tuned):
    runs = [api.sample(_alg(tuned, 64), jr.key(8, device=CPU), 30,
                       chunk_size=cs, device=CPU) for cs in (30, 7)]
    assert torch.equal(runs[0].theta, runs[1].theta)


def test_chain_batched_equals_per_chain_runs(tuned):
    alg = _alg(tuned, 64)
    key = jr.key(9, device=CPU)
    both = api.sample(alg, key, 25, num_chains=2, device=CPU)
    k_init, k_steps = jr.split(key)
    init_keys, chain_keys = jr.split(k_init, 2), jr.split(k_steps, 2)
    for c in range(2):
        st = alg.init(init_keys[c:c + 1], alg.default_position[None])
        one = api.sample(alg, chain_keys[c], 25, init_state=st, device=CPU)
        assert torch.equal(one.theta[0], both.theta[c])


def test_resume_equals_contiguous(tuned):
    alg = _alg(tuned, 64)
    key = jr.key(10, device=CPU)
    st0 = alg.init(jr.split(key, 2), alg.default_position.expand(2, -1))
    whole = api.sample(alg, key, 30, num_chains=2, init_state=st0, device=CPU)
    a = api.sample(alg, key, 12, num_chains=2, init_state=st0, device=CPU)
    b = api.sample(a.algorithm, key, 18, num_chains=2, init_state=a.final_state,
                   device=CPU)
    assert torch.equal(whole.theta, torch.cat([a.theta, b.theta], dim=1))


def test_fused_z_with_explicit_mode_raises_like_the_reference(tuned):
    with pytest.raises(ValueError, match="requires mode='implicit'"):
        api.firefly(tuned, mode="explicit", device=CPU)
    spec = tflymc.FlyMCSpec(bound=tuned.bound, log_prior=tuned.log_prior,
                            capacity=64, cand_capacity=64, mode="explicit")
    alg = api.algorithm_from_spec(spec, tuned.data, tuned.stats)
    with pytest.raises(ValueError, match="requires mode='implicit'"):
        api.sample(alg, jr.key(0, device=CPU), 1, device=CPU)


def test_no_firefly_knob_of_the_reference_raises_not_implemented(tuned):
    import inspect

    # Every knob but axis_names, the distributed one (ROADMAP queue 1).
    ref = set(inspect.signature(japi.firefly).parameters) - {"axis_names"}
    assert ref <= set(inspect.signature(api.firefly).parameters)
    engines = [dict(backend=b, z_backend=z) for b in ("jnp", "pallas")
               for z in ("jnp", "fused")]
    engines += [dict(backend=b, z_backend="jnp", mode="explicit",
                     resample_fraction=0.05) for b in ("jnp", "pallas")]
    for kw in engines:
        for kernel in ("rwmh", "mala", "slice", "hmc"):
            alg = api.firefly(tuned, kernel=kernel, capacity=64,
                              cand_capacity=64, q_db=0.02, step_size=0.02,
                              kernel_params=(("n_leapfrog", 2),)
                              if kernel == "hmc" else (), device=CPU, **kw)
            tr = api.sample(alg, jr.key(0, device=CPU), 2, num_chains=2,
                            device=CPU)
            assert bool(torch.isfinite(tr.theta).all()), (kernel, kw)


# ---------------------------------------------------------------------------
# Chain law against the JAX package
# ---------------------------------------------------------------------------


def _mean_and_se(theta):
    """(K, T, D) samples → pooled mean and its Monte-Carlo standard error
    (per coordinate, from the chains' summed Geyer ESS)."""
    th = np.asarray(theta, np.float64)
    se = []
    for j in range(th.shape[2]):
        ess = sum(diagnostics.effective_sample_size(th[c][:, j])
                  for c in range(th.shape[0]))
        se.append(th[:, :, j].std() / np.sqrt(max(ess, 1.0)))
    return th.reshape(-1, th.shape[2]).mean(0), np.array(se)


def test_sampling_run_matches_jax_chain_law():
    # FlyMC's θ–z coupling mixes slowly: on this problem both packages
    # reach an ESS of ~2-3% of the iterations, so R̂ needs ~1000 samples.
    n, d, iters, warm = 1000, 3, 1500, 300
    jdata = jax_logistic_data(jax.random.key(0), n=n, d=d)
    jmodel = JGLMModel.logistic(jdata)
    jth = jmodel.map_estimate(jax.random.key(1), steps=200)
    jtuned = jmodel.map_tuned(jth)
    jalg = japi.firefly(jtuned, kernel="rwmh", capacity=256, cand_capacity=256,
                        q_db=0.02, step_size=0.1, adapt_target="auto",
                        num_warmup=warm)
    jtr = japi.sample(jalg, jax.random.key(2), iters, num_chains=2,
                      init_position=jth)

    x = np.asarray(jdata.x)
    t = np.asarray(jdata.t)
    model = GLMModel.logistic(convert.glm_data(x, t, np.zeros(n), device=CPU),
                              device=CPU)
    tuned = model.map_tuned(convert.theta(np.asarray(jth), device=CPU)[0])
    alg = api.firefly(tuned, kernel="rwmh", capacity=256, cand_capacity=256,
                      q_db=0.02, step_size=0.1, adapt_target="auto",
                      num_warmup=warm, device=CPU)
    tr = api.sample(alg, jr.key(2, device=CPU), iters, num_chains=2,
                    init_position=convert.theta(np.asarray(jth), device=CPU)[0],
                    collectors={"trace": api.FullTrace(), "rhat": api.RHat(),
                                "q": api.QueryBudget()}, device=CPU)
    theta_t = tr.results["trace"]["theta"].numpy()[:, warm:]
    theta_j = np.asarray(jtr.theta)[:, warm:]
    m_t, se_t = _mean_and_se(theta_t)
    m_j, se_j = _mean_and_se(theta_j)
    assert np.all(np.abs(m_t - m_j) < 4 * np.sqrt(se_t**2 + se_j**2))
    q_t = tr.results["trace"]["stats"].lik_queries[:, warm:].double().mean().item()
    q_j = float(np.asarray(jtr.stats.lik_queries)[:, warm:].mean())
    assert abs(q_t - q_j) < 0.1 * q_j
    assert tr.results["q"] == int(tr.results["trace"]["stats"].lik_queries.sum())
    assert diagnostics.split_r_hat(theta_t) < 1.1
    assert brightness.check_invariants(tr.final_state.bright)


# ---------------------------------------------------------------------------
# Package rules
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tuned):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jr.key(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        logistic_data(jr.key(0, device=CPU), n=10, d=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.firefly(tuned)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.sample(_alg(tuned, 8), jr.key(0, device=CPU), 2)
