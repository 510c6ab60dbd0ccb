"""Port parity for every FlyMC engine, mode and θ-kernel of the reference.

One ``flymc_step`` from a shared state against the JAX package for the
plain engines (``backend="jnp"``, ``z_backend="jnp"``) and explicit mode in
each bound family, and for slice sampling and HMC on the kernel engines;
then the port's exactness contracts for each of them (capacity and overflow
re-runs, chunk size, batched == solo, resume == contiguous), bitwise.

The JAX kernel engines run in interpret mode, as the JAX package's own
tests run them on the CPU.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import brightness as jbrightness
from repro.core import flymc as jflymc
from repro.data import logistic_data as jax_logistic_data
from repro.data import robust_data as jax_robust_data
from repro.data import softmax_data as jax_softmax_data
from repro.models.bayes_glm import GLMModel as JGLMModel
from repro_torch import api, convert
from repro_torch import random as jr
from repro_torch.core import bounds as tbounds
from repro_torch.core import brightness
from repro_torch.core import flymc as tflymc
from repro_torch.data import logistic_data
from repro_torch.models.bayes_glm import GLMModel
from _torch_grad_invariance import assert_bound_gradients_batch_invariant
from test_torch_flymc import _to_port
from test_torch_samplers import hmc_log_ratio, slice_margins

CPU = "cpu"


# ---------------------------------------------------------------------------
# One step against the JAX package
# ---------------------------------------------------------------------------


def _jax_problem(family):
    key = jax.random.key(0)
    if family == "logistic":
        model = JGLMModel.logistic(jax_logistic_data(key, n=900, d=6))
    elif family == "softmax":
        model = JGLMModel.softmax(jax_softmax_data(key, n=900, d=6, k=3),
                                  n_classes=3)
    else:
        data, _ = jax_robust_data(key, n=900, d=6, nu=4.0)
        model = JGLMModel.robust(data, nu=4.0, sigma=1.0, prior_scale=1.0)
    th = model.map_estimate(jax.random.key(1), steps=150)
    return model.map_tuned(th), th


def _port_bound(family):
    if family == "logistic":
        return (tbounds.LogisticBound(),
                partial(tbounds.gaussian_log_prior, scale=1.0))
    if family == "softmax":
        return (tbounds.SoftmaxBound(),
                partial(tbounds.gaussian_log_prior, scale=1.0))
    return (tbounds.StudentTBound(nu=4.0, sigma=1.0),
            partial(tbounds.laplace_log_prior, scale=1.0))


def _theta_margin(spec, model, state):
    """The smallest distance of any θ-kernel decision of the next JAX step
    from its edge: |log u − log ratio| (RWMH, HMC), or every |lp − log y|
    of a slice step."""
    key_theta = jax.random.split(state.rng, 3)[0]
    idx, mask = jbrightness.bright_buffer(state.bright, spec.capacity)
    f = jax.jit(jflymc.make_joint_logpost(spec, model.data, model.stats, idx,
                                          mask))
    eps = jnp.exp(state.log_step)
    st = state.sampler
    kw = dict(spec.kernel_kwargs)
    if spec.kernel == "slice":
        return slice_margins(f, key_theta, st, eps, **kw)[0]
    if spec.kernel == "hmc":
        return hmc_log_ratio(f, key_theta, st, eps, **kw)[0]
    k_prop, k_acc = jax.random.split(key_theta)
    th_p = st.theta + eps * jax.random.normal(k_prop, st.theta.shape)
    log_ratio = f(th_p)[0] - st.lp
    log_u = jnp.log(jax.random.uniform(k_acc, ()))
    return abs(float(log_u - log_ratio))


def _step_parity(family, kernel, step, engines, kernel_kwargs=(),
                 seeds=(3, 4)):
    model, th_map = _jax_problem(family)
    common = dict(kernel=kernel, capacity=128, cand_capacity=64, q_db=0.02,
                  kernel_kwargs=kernel_kwargs, **engines)
    spec = jflymc.FlyMCSpec(bound=model.bound, log_prior=model.log_prior,
                            **common)
    init = jax.jit(lambda k: jflymc.init_chain_state(
        spec, model.data, model.stats, th_map, k, step_size=step))
    step_fn = jax.jit(lambda st: jflymc.flymc_step(spec, model.data,
                                                   model.stats, st))
    states, outs, margins = [], [], []
    for seed in seeds:  # chains batched in the port
        st = init(jax.random.key(seed))
        margins.append(_theta_margin(spec, model, st))
        states.append(_to_port(st))
        outs.append(step_fn(st))
    assert min(margins) > 1e-4, margins  # decisions are not knife-edge

    d = jax.device_get(model.data)
    tdata = convert.glm_data(d.x, d.t, d.xi, device=CPU)
    tstats = convert.collapsed_stats(*jax.device_get(model.stats), device=CPU)
    bound, prior = _port_bound(family)
    tspec = tflymc.FlyMCSpec(bound=bound, log_prior=prior, **common)
    batched = {k: np.stack([s[k] for s in states]) for k in states[0]}
    tstate = convert.flymc_state(**batched, device=CPU, batched=True)
    new, stats = tflymc.flymc_step(tspec, tdata, tstats, tstate)

    for i, (ref, ref_stats) in enumerate(outs):
        ref = jax.device_get(ref)
        np.testing.assert_array_equal(new.bright.arr[i].numpy(), ref.bright.arr)
        np.testing.assert_array_equal(new.bright.tab[i].numpy(), ref.bright.tab)
        assert int(new.bright.num[i]) == int(ref.bright.num)
        np.testing.assert_allclose(new.sampler.theta[i].numpy(),
                                   ref.sampler.theta, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(new.delta_full[i].numpy(), ref.delta_full,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(new.rng[i].numpy(),
                                      np.asarray(jax.random.key_data(ref.rng)))
        assert int(stats.lik_queries[i]) == int(ref_stats.lik_queries)
        assert bool(stats.overflow[i]) == bool(ref_stats.overflow)
        assert bool(stats.accept_prob[i] > 0) == bool(ref_stats.accept_prob > 0)
    return stats


ENGINES = {
    "plain-theta": dict(backend="jnp", z_backend="fused"),
    "plain-z": dict(backend="pallas", z_backend="jnp"),
    "plain": dict(backend="jnp", z_backend="jnp"),
    "explicit": dict(backend="jnp", z_backend="jnp", mode="explicit",
                     resample_fraction=0.1),
}
STEP = {"logistic": 0.05, "softmax": 0.02, "student_t": 0.02}


@pytest.mark.parametrize("family", ["logistic", "softmax", "student_t"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_one_step_of_each_engine_matches_jax(family, engine):
    stats = _step_parity(family, "rwmh", STEP[family], ENGINES[engine])
    if engine == "explicit":  # r = round(900 · 0.1) resampled data a step
        assert bool((stats.lik_queries >= 90).all())


@pytest.mark.parametrize("family,kernel,step,kw", [
    ("student_t", "slice", 0.05, ()),
    ("logistic", "slice", 0.5, ()),
    ("logistic", "hmc", 0.05, (("n_leapfrog", 5),)),
    ("softmax", "hmc", 0.01, (("n_leapfrog", 3),)),
])
def test_one_step_of_slice_and_hmc_matches_jax(family, kernel, step, kw):
    _step_parity(family, kernel, step, dict(backend="pallas",
                                            z_backend="fused"), kw)


def test_hmc_on_the_plain_engines_matches_jax():
    _step_parity("logistic", "hmc", 0.05, ENGINES["plain"],
                 (("n_leapfrog", 4),))


# ---------------------------------------------------------------------------
# Exactness contracts within the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tuned():
    data = logistic_data(jr.key(0, device=CPU), n=600, d=5, device=CPU)
    model = GLMModel.logistic(data, device=CPU)
    return model.map_tuned(model.map_estimate(jr.key(1, device=CPU), steps=150))


CONFIGS = {
    "slice": dict(kernel="slice", step_size=0.3),
    "hmc": dict(kernel="hmc", step_size=0.03, kernel_params=(("n_leapfrog", 3),)),
    "plain": dict(kernel="rwmh", step_size=0.05, backend="jnp", z_backend="jnp"),
    "plain-hmc": dict(kernel="hmc", step_size=0.03, backend="jnp",
                      z_backend="jnp", kernel_params=(("n_leapfrog", 3),)),
    "explicit": dict(kernel="rwmh", step_size=0.05, backend="jnp",
                     z_backend="jnp", mode="explicit", resample_fraction=0.05),
}


def _alg(model, config, cap, cand=None):
    return api.firefly(model, capacity=cap, cand_capacity=cand or cap,
                       q_db=0.02, adapt_target="auto", num_warmup=10,
                       device=CPU, **CONFIGS[config])


@pytest.mark.parametrize("config", list(CONFIGS))
def test_capacity_and_overflow_rerun_are_bitwise_exact(tuned, config):
    big = api.sample(_alg(tuned, config, 256), jr.key(7, device=CPU), 24,
                     num_chains=2, device=CPU)
    # ~12 dark→bright candidates a step overflow a buffer of 2: re-runs
    small = api.sample(_alg(tuned, config, 8, cand=2), jr.key(7, device=CPU),
                       24, num_chains=2, chunk_size=8, device=CPU)
    assert small.algorithm.spec.capacity > 8  # it overflowed and grew
    assert small.steps_run > 24 and small.inits_run > 1
    assert torch.equal(big.theta, small.theta)
    for a, b in zip(big.stats, small.stats):
        assert torch.equal(a, b)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_chunk_size_does_not_change_the_chain(tuned, config):
    runs = [api.sample(_alg(tuned, config, 64), jr.key(8, device=CPU), 20,
                       chunk_size=cs, device=CPU) for cs in (20, 7)]
    assert torch.equal(runs[0].theta, runs[1].theta)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_chain_batched_equals_per_chain_runs(tuned, config):
    alg = _alg(tuned, config, 64)
    key = jr.key(9, device=CPU)
    both = api.sample(alg, key, 16, num_chains=2, device=CPU)
    k_init, k_steps = jr.split(key)
    init_keys, chain_keys = jr.split(k_init, 2), jr.split(k_steps, 2)
    for c in range(2):
        st = alg.init(init_keys[c:c + 1], alg.default_position[None])
        one = api.sample(alg, chain_keys[c], 16, init_state=st, device=CPU)
        assert torch.equal(one.theta[0], both.theta[c])
        for a, b in zip(one.stats, both.stats):
            assert torch.equal(a[0], b[c])


@pytest.mark.parametrize("config", list(CONFIGS))
def test_resume_equals_contiguous(tuned, config):
    alg = _alg(tuned, config, 64)
    key = jr.key(10, device=CPU)
    st0 = alg.init(jr.split(key, 2), alg.default_position.expand(2, -1))
    whole = api.sample(alg, key, 18, num_chains=2, init_state=st0, device=CPU)
    a = api.sample(alg, key, 7, num_chains=2, init_state=st0, device=CPU)
    b = api.sample(a.algorithm, key, 11, num_chains=2,
                   init_state=a.final_state, device=CPU)
    assert torch.equal(whole.theta, torch.cat([a.theta, b.theta], dim=1))
    assert brightness.check_invariants(b.final_state.bright)


def test_model_glue_builds_the_same_algorithms(tuned):
    """``GLMModel.algorithm``/``flymc_spec``/``baseline``, as the reference
    has them: the spec route and the keyword route give one chain."""
    kw = dict(kernel="slice", capacity=64, cand_capacity=64, q_db=0.02)
    key = jr.key(12, device=CPU)
    a = api.sample(tuned.algorithm(step_size=0.3, **kw), key, 6,
                   num_chains=2, device=CPU)
    spec = tuned.flymc_spec(**kw)
    b = api.sample(api.algorithm_from_spec(spec, tuned.data, tuned.stats,
                                           step_size=0.3), key, 6,
                   num_chains=2, device=CPU)
    assert torch.equal(a.theta, b.theta)
    base = api.sample(tuned.baseline(kernel="hmc", step_size=0.05), key, 4,
                      num_chains=2, device=CPU)
    assert bool((base.stats.lik_queries == 11 * 600).all())


@pytest.mark.parametrize("family", ["logistic", "softmax", "student_t"])
@pytest.mark.parametrize("d", [9, 57, 256])
def test_bound_gradients_are_batch_invariant(family, d):
    """The collapsed bound's gradient does not change with the chain count
    (MALA's and HMC's batched == solo); the card runs the same check."""
    assert_bound_gradients_batch_invariant(family, d, CPU)
