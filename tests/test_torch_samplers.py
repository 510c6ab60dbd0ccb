"""Port parity for the θ-kernels the FlyMC main path did not carry — slice
sampling and HMC — and for ``random.permutation``.

Slice and HMC run alone on a Gaussian target against
``repro.core.samplers`` (one step from a shared state, its decisions held
away from the knife's edge, and the target's moments), then on the paper's
third experiment: a small robust Student-t regression whose FlyMC slice
chain must have the JAX chain's law.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import samplers as jsamplers
from repro.data import robust_data as jax_robust_data
from repro.models.bayes_glm import GLMModel as JGLMModel
from repro_torch import api, convert
from repro_torch import random as jr
from repro_torch.core import samplers
from repro_torch.core.numerics import flat_tree_sum
from repro_torch.models.bayes_glm import GLMModel
from test_torch_flymc import _mean_and_se

CPU = "cpu"


# ---------------------------------------------------------------------------
# random.permutation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 1000, 1625, 1626, 5000])
def test_permutation_is_jax_permutation_bitwise(n):
    # n ≤ 1625 takes one sort round, n ≥ 1626 two
    keys = [jax.random.key(s) for s in (0, 3, 11)]
    ref = np.stack([np.asarray(jax.random.permutation(
        k, jnp.arange(n, dtype=jnp.int32))) for k in keys])
    words = np.stack([np.asarray(jax.random.key_data(k)) for k in keys])
    got = jr.permutation(convert.key_words(words, CPU, batched=True), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_permutation_at_the_opv_width_is_bitwise():
    n = 1_800_000  # two rounds, bits ≥ 2³¹ in every round
    k = jax.random.key(5)
    ref = np.asarray(jax.random.permutation(k, jnp.arange(n, dtype=jnp.int32)))
    got = jr.permutation(convert.key_words(
        np.asarray(jax.random.key_data(k)), CPU), n)
    np.testing.assert_array_equal(got[0].numpy(), ref)


# ---------------------------------------------------------------------------
# Knife-edge margins of the reference's decisions
# ---------------------------------------------------------------------------


def slice_margins(f, key, state, width, max_step_out=8, max_shrink=32):
    """The reference's slice step written out eagerly: returns
    (min |lp − log y| over every comparison the step makes, θ', n_evals).
    ``f`` is a JAX ``θ -> (lp, aux)`` for one chain."""
    k_dir, k_h, k_u, k_shrink = jax.random.split(key, 4)
    d = jax.random.normal(k_dir, state.theta.shape, state.theta.dtype)
    d = d / jnp.sqrt(jnp.sum(jnp.square(d)))
    log_y = state.lp + jnp.log(jax.random.uniform(k_h, (), state.lp.dtype))
    gaps = []

    def above(s):
        lp = f(state.theta + s * d)[0]
        gaps.append(abs(float(lp - log_y)))
        return bool(lp > log_y)

    u = jax.random.uniform(k_u, (), state.lp.dtype)
    lo, hi = -width * u, width * (1.0 - u)
    n_evals = 0
    for sign in (-1.0, 1.0):
        b = lo if sign < 0 else hi
        n_evals += 1
        i = 0
        inside = above(b)
        while inside and i < max_step_out:
            b = b + sign * width
            inside = above(b)
            i += 1
        n_evals += i
        if sign < 0:
            lo = b
        else:
            hi = b
    s = jnp.zeros((), state.lp.dtype)
    for i in range(max_shrink):
        k = jax.random.fold_in(k_shrink, i)
        s2 = lo + (hi - lo) * jax.random.uniform(k, (), state.lp.dtype)
        n_evals += 1
        if above(s2):
            s = s2
            break
        lo, hi = (lo, s2) if s2 >= 0.0 else (s2, hi)
    return min(gaps), state.theta + s * d, n_evals


def hmc_log_ratio(f, key, state, step_size, n_leapfrog=10):
    """(|log u − log ratio|, log ratio) of the reference's HMC step."""
    vg = jax.value_and_grad(f, has_aux=True)
    k_mom, k_acc = jax.random.split(key)
    p0 = jax.random.normal(k_mom, state.theta.shape, state.theta.dtype)
    th, p, g = state.theta, p0, state.grad
    for _ in range(n_leapfrog):
        p_half = p + 0.5 * step_size * g
        th = th + step_size * p_half
        (_, _), g = vg(th)
        p = p_half + 0.5 * step_size * g
    lp = f(th)[0]
    log_ratio = (-state.lp + 0.5 * jnp.sum(jnp.square(p0))) - (
        -lp + 0.5 * jnp.sum(jnp.square(p)))
    log_u = jnp.log(jax.random.uniform(k_acc, (), state.lp.dtype))
    return abs(float(log_u - log_ratio)), float(log_ratio)


# ---------------------------------------------------------------------------
# Slice and HMC alone, on a Gaussian target
# ---------------------------------------------------------------------------

MEAN = np.array([1.0, -2.0, 0.5], np.float32)
STD = np.array([1.0, 0.5, 2.0], np.float32)


def _jax_target(theta):
    z = (theta - jnp.asarray(MEAN)) / jnp.asarray(STD)
    return -0.5 * jnp.sum(z * z), jnp.zeros((), theta.dtype)


def _torch_target(theta):
    z = (theta - torch.from_numpy(MEAN)) / torch.from_numpy(STD)
    lp = -0.5 * flat_tree_sum(z * z)
    return lp, torch.zeros_like(lp)


def _states(kernel, seeds):
    """JAX states (one per seed) and the port's batched state from them."""
    rng = np.random.default_rng(seeds[0])
    js = []
    for _ in seeds:
        th = jnp.asarray(MEAN + STD * rng.normal(size=3).astype(np.float32))
        js.append(jsamplers.init_state(_jax_target, th,
                                       with_grad=kernel == "hmc"))
    th = torch.from_numpy(np.stack([np.asarray(s.theta) for s in js]))
    ts = samplers.init_state(_torch_target, th, with_grad=kernel == "hmc")
    return js, ts


def _keys(seeds):
    keys = [jax.random.key(s) for s in seeds]
    words = np.stack([np.asarray(jax.random.key_data(k)) for k in keys])
    return keys, convert.key_words(words, CPU, batched=True)


def test_slice_step_matches_jax_per_chain():
    seeds = list(range(20, 26))
    js, ts = _states("slice", seeds)
    keys, tkeys = _keys(seeds)
    width = 1.5
    new, info = samplers.slice_step(_torch_target, tkeys, ts,
                                    torch.full((len(seeds),), width))
    assert info.n_evals.shape == (len(seeds),)
    assert len(set(info.n_evals.tolist())) > 1  # the count differs by chain
    step = jax.jit(lambda k, s: jsamplers.slice_step(_jax_target, k, s, width))
    for c, (k, s) in enumerate(zip(keys, js)):
        margin, th_mirror, n_mirror = slice_margins(_jax_target, k, s, width)
        ref, ref_info = step(k, s)
        np.testing.assert_allclose(th_mirror, ref.theta, rtol=1e-6, atol=1e-6)
        assert n_mirror == int(ref_info.n_evals)  # the mirror is the reference
        assert margin > 1e-4, margin
        assert int(info.n_evals[c]) == int(ref_info.n_evals)
        assert bool(info.accepted[c]) == bool(ref_info.accepted)
        np.testing.assert_allclose(new.theta[c].numpy(), ref.theta,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(new.lp[c]), float(ref.lp), rtol=1e-5,
                                   atol=1e-6)


def test_hmc_step_matches_jax_per_chain():
    seeds = list(range(30, 36))
    js, ts = _states("hmc", seeds)
    keys, tkeys = _keys(seeds)
    eps = 0.3
    new, info = samplers.hmc_step(_torch_target, tkeys, ts,
                                  torch.full((len(seeds),), eps), n_leapfrog=6)
    assert info.n_evals == 7
    step = jax.jit(lambda k, s: jsamplers.hmc_step(_jax_target, k, s, eps,
                                                   n_leapfrog=6))
    for c, (k, s) in enumerate(zip(keys, js)):
        margin, _ = hmc_log_ratio(_jax_target, k, s, eps, n_leapfrog=6)
        assert margin > 1e-4, margin
        ref, ref_info = step(k, s)
        assert bool(info.accepted[c]) == bool(ref_info.accepted)
        assert int(ref_info.n_evals) == 7
        np.testing.assert_allclose(new.theta[c].numpy(), ref.theta,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(new.grad[c].numpy(), ref.grad,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(info.accept_prob[c]),
                                   float(ref_info.accept_prob), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("kernel,scale,kw", [
    ("slice", 2.0, {}), ("hmc", 0.35, {"n_leapfrog": 8}),
])
def test_kernel_recovers_gaussian_moments(kernel, scale, kw):
    """128 chains batched, 300 steps each, from the mode: the pooled
    moments of the last 200."""
    k = 128
    kern = samplers.make_kernel(kernel, _torch_target, **kw)
    th = torch.from_numpy(np.tile(MEAN, (k, 1)))
    st = samplers.init_state(_torch_target, th, with_grad=kernel == "hmc")
    keys = jr.split(jr.key(4, device=CPU), k)
    width = torch.full((k,), scale)
    out = []
    for i in range(300):
        st, info = kern(jr.fold_in(keys, i), st, width)
        out.append(st.theta)
    s = torch.stack(out[100:], dim=1).reshape(-1, 3).double().numpy()
    se = STD / math.sqrt(k * 200 / 10)  # ESS ≥ a tenth of the draws
    np.testing.assert_array_less(np.abs(s.mean(0) - MEAN), 4 * se)
    np.testing.assert_allclose(s.std(0), STD, rtol=0.1)
    assert np.isfinite(s).all()


@pytest.mark.parametrize("kernel", ["slice", "hmc"])
def test_batched_chains_equal_solo_chains_bitwise(kernel):
    seeds = list(range(40, 44))
    _, ts = _states(kernel, seeds)
    _, tkeys = _keys(seeds)
    scale = torch.full((len(seeds),), 1.0 if kernel == "slice" else 0.3)
    kern = samplers.make_kernel(kernel, _torch_target)
    both, info = kern(tkeys, ts, scale)
    for c in range(len(seeds)):
        one = samplers.SamplerState(*(a[c:c + 1] for a in ts))
        solo, solo_info = kern(tkeys[c:c + 1], one, scale[c:c + 1])
        for a, b in zip(solo, both):
            assert torch.equal(a[0], b[c])
        if kernel == "slice":
            assert int(solo_info.n_evals[0]) == int(info.n_evals[c])


def test_slice_caps_its_loops_and_keeps_finished_chains():
    """A tiny width steps out to the cap; max_shrink=1 leaves chains whose
    one shrink draw fell outside the slice at their start, untouched."""
    seeds = list(range(50, 58))
    _, ts = _states("slice", seeds)
    _, tkeys = _keys(seeds)
    new, info = samplers.slice_step(_torch_target, tkeys, ts,
                                    torch.full((8,), 1e-3), max_step_out=3,
                                    max_shrink=1)
    assert torch.equal(info.n_evals, torch.full((8,), 2 * (1 + 3) + 1,
                                                dtype=torch.int32))
    wide, winfo = samplers.slice_step(_torch_target, tkeys, ts,
                                      torch.full((8,), 50.0), max_shrink=1)
    stay = ~winfo.accepted
    assert bool(stay.any())
    assert torch.equal(wide.theta[stay], ts.theta[stay])
    assert torch.equal(wide.lp[stay], ts.lp[stay])


# ---------------------------------------------------------------------------
# The paper's third experiment at a small N: the FlyMC slice chain's law
# ---------------------------------------------------------------------------


def test_robust_slice_chain_matches_jax_chain_law():
    n, d, iters, warm = 2000, 4, 700, 100
    jdata, _ = jax_robust_data(jax.random.key(0), n=n, d=d, nu=4.0)
    jmodel = JGLMModel.robust(jdata, nu=4.0, sigma=1.0, prior_scale=1.0)
    jth = jmodel.map_estimate(jax.random.key(1), steps=300, lr=0.02)
    jtuned = jmodel.map_tuned(jth)
    jalg = japi.firefly(jtuned, kernel="slice", capacity=256,
                        cand_capacity=256, q_db=0.01, step_size=0.05)
    jtr = japi.sample(jalg, jax.random.key(2), iters, num_chains=2,
                      init_position=jth)

    d_np = jax.device_get(jdata)
    model = GLMModel.robust(convert.glm_data(d_np.x, d_np.t, d_np.xi, CPU),
                            nu=4.0, sigma=1.0, prior_scale=1.0, device=CPU)
    th0 = convert.theta(np.asarray(jth), CPU)[0]
    tuned = model.map_tuned(th0)
    alg = api.firefly(tuned, kernel="slice", capacity=256, cand_capacity=256,
                      q_db=0.01, step_size=0.05, device=CPU)
    tr = api.sample(alg, jr.key(2, device=CPU), iters, num_chains=2,
                    init_position=th0, device=CPU)
    m_t, se_t = _mean_and_se(tr.theta.numpy()[:, warm:])
    m_j, se_j = _mean_and_se(np.asarray(jtr.theta)[:, warm:])
    assert np.all(np.abs(m_t - m_j) < 4 * np.sqrt(se_t**2 + se_j**2))
    q_t = tr.stats.lik_queries[:, warm:].double().mean().item()
    q_j = float(np.asarray(jtr.stats.lik_queries)[:, warm:].mean())
    assert abs(q_t - q_j) < 0.15 * q_j
    assert float(tr.stats.accept_prob.min()) == 1.0
