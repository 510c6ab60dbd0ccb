"""Port parity: FlyMC over an LM head (repro_torch.models.lastlayer) against
the JAX package, and the pieces it adds to the FlyMC core: the softmax
bright-GLM plain version at an LM vocabulary and the matmul form of the
Böhning collapsed term.

Backbones are the reduced twins of llama3.2-3b, rwkv6-7b and
recurrentgemma-9b (vocab 512, d_model 128), both packages on the JAX
``init_model(key 0)`` weights carried by :func:`repro_torch.convert.
lm_params`, tokens (2, 33): N = 64 tokens. Tolerances: features 1e-4
absolute and relative (float32 through the backbone); the collapsed
statistics 1e-4 relative (sums of 64 rows); δ from the plain version 1e-5
against the JAX oracle and the Pallas kernel in interpret mode; one FlyMC
step: partitions and counts bitwise, θ to 1e-5 relative and 1e-6 absolute,
δ to 1e-5, with the θ decision held ≥ 1e-4 from its edge first. The
contracts (capacity, batched == solo) are bitwise.
"""

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import bounds as jbounds
from repro.core import flymc as jflymc
from repro.kernels.bright_glm.ops import bright_glm as jax_bright_glm
from repro.kernels.bright_glm.ref import bright_glm_ref as jax_bright_glm_ref
from repro.models import transformer as JT
from repro.models.lastlayer import extract_features as jax_extract_features
from repro.models.lastlayer import lastlayer_glm as jax_lastlayer_glm
from repro_torch import api, convert
from repro_torch import random as jr
from repro_torch.configs import get_reduced
from repro_torch.core import bounds as tbounds
from repro_torch.core import flymc as tflymc
from repro_torch.kernels.bright_glm import ops as bops
from repro_torch.models import transformer as T
from repro_torch.models.lastlayer import extract_features, lastlayer_glm
from _torch_grad_invariance import assert_softmax_collapsed_batch_invariant
from test_torch_flymc import _log_ratio_margin, _to_port

CPU = "cpu"
ARCHS = ("llama3.2-3b", "rwkv6-7b", "recurrentgemma-9b")
TOL = dict(rtol=1e-4, atol=1e-4)
PRIOR = 0.003  # the reference example's prior scale


class Pair:
    """One reduced backbone in both packages, and a batch of tokens."""

    def __init__(self, arch):
        self.jcfg = jax_get_reduced(arch)
        self.cfg = get_reduced(arch)
        self.params, self.specs = JT.init_model(self.jcfg, jax.random.key(0))
        self.model = convert.lm_params(jax.device_get(self.params), self.cfg,
                                       CPU)
        self.tokens = np.random.default_rng(1).integers(
            0, self.cfg.vocab_size, (2, 33)).astype(np.int32)

    def t(self):
        return torch.from_numpy(self.tokens.astype(np.int64))

    def jax_glm(self):
        return jax_lastlayer_glm(self.params, self.specs, self.jcfg,
                                 {"tokens": jnp.asarray(self.tokens)},
                                 prior_scale=PRIOR)


@functools.cache
def _pair(arch):
    return Pair(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_extract_features_match_jax(arch):
    p = _pair(arch)
    jf, jl = jax_extract_features(p.params, p.specs, p.jcfg,
                                  {"tokens": jnp.asarray(p.tokens)})
    feats, labels = extract_features(p.model, p.t())
    assert feats.dtype == torch.float32 and feats.shape == (64, 128)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jf), **TOL)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))


@pytest.mark.parametrize("arch", ARCHS)
def test_lastlayer_glm_matches_jax(arch):
    p = _pair(arch)
    jm = p.jax_glm()
    m = lastlayer_glm(p.model, p.t(), prior_scale=PRIOR)
    assert m.theta_shape == tuple(jm.theta_shape) == (512, 128)
    assert m.device.type == "cpu"
    np.testing.assert_allclose(m.data.x.numpy(), np.asarray(jm.data.x), **TOL)
    np.testing.assert_array_equal(m.data.t.numpy(), np.asarray(jm.data.t))
    np.testing.assert_array_equal(m.data.xi.numpy(), np.asarray(jm.data.xi))
    for got, want in zip(m.stats, jm.stats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-3)
    # the prior: θ ~ N(0, 0.003²), the reference's
    th = 0.01 * np.random.default_rng(2).normal(size=(512, 128))
    th = th.astype(np.float32)
    np.testing.assert_allclose(
        float(m.log_prior(torch.from_numpy(th)[None])[0]),
        float(jm.log_prior(jnp.asarray(th))), rtol=1e-5)


def _wide_inputs(kc=512, n=40, d=32, k=2, c=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    t = rng.integers(0, kc, n).astype(np.int32)
    xi = rng.normal(0, 1, (n, kc)).astype(np.float32)
    theta = rng.normal(0, 0.3, (k, kc, d)).astype(np.float32)
    idx = np.stack([rng.permutation(n)[:c] for _ in range(k)]).astype(np.int32)
    idx[:, -3:] = n  # candidate-buffer sentinels
    nb = np.array([c - 5, c // 2])[:k]
    return x, t, xi, idx, nb, theta


def test_wide_softmax_plain_matches_jax_ref_and_pallas():
    """The bright-GLM plain version at Kc = 512 (the reduced twin's padded
    vocabulary; on the card, the wide kernel's shape) against the JAX
    oracle and the Pallas kernel in interpret mode, chain by chain."""
    x, t, xi, idx, nb, theta = _wide_inputs()
    args = (torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)),
            torch.from_numpy(xi), torch.from_numpy(idx),
            torch.from_numpy(nb.astype(np.int64)), torch.from_numpy(theta))
    assert not bops.register_path(512, 32)  # the wide kernel's on the card
    delta, total = bops.bright_glm(*args, family="softmax")
    for i in range(2):
        mask = np.arange(idx.shape[1]) < nb[i]
        d_ref, contrib = jax_bright_glm_ref(
            jnp.asarray(x), jnp.asarray(t), jnp.asarray(xi),
            jnp.asarray(idx[i]), jnp.asarray(mask), jnp.asarray(theta[i]),
            family="softmax")
        d_pl, t_pl = jax_bright_glm(
            jnp.asarray(x), jnp.asarray(t), jnp.asarray(xi),
            jnp.asarray(idx[i]), jnp.int32(nb[i]), jnp.asarray(theta[i]),
            family="softmax", interpret=True)
        valid = slice(0, idx.shape[1] - 3)  # the sentinels: NaN in jnp.take
        for want in (d_ref, d_pl):
            np.testing.assert_allclose(delta[i, valid].numpy(),
                                       np.asarray(want)[valid], rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(float(total[i]), float(jnp.sum(contrib)),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(total[i]), float(t_pl), rtol=1e-5)


def test_wide_plain_version_is_capacity_and_batch_invariant_bitwise():
    """Past the register kernel the plain version takes fixed-shape matmuls
    of 64 slots: δ, the total and the θ-gradient of a chain are the same
    bits at capacity 24 and 200 (padding past the bright count) and alone
    or beside another chain."""
    x, t, xi, idx, nb, theta = _wide_inputs(n=300, c=200, seed=1)
    base = [torch.from_numpy(a) for a in (x, t.astype(np.int64), xi)]
    nb = torch.tensor([20, 13])

    def run(idx_, nb_, th_):
        th = torch.from_numpy(th_).requires_grad_(True)
        delta, total = bops.bright_glm(*base, torch.from_numpy(idx_), nb_, th,
                                       family="softmax")
        (g,) = torch.autograd.grad(total.sum(), th)
        return delta.detach(), total.detach(), g

    d_big, t_big, g_big = run(idx, nb, theta)
    d_small, t_small, g_small = run(np.ascontiguousarray(idx[:, :24]), nb,
                                    theta)
    assert torch.equal(d_small, d_big[:, :24])
    assert torch.equal(t_small, t_big) and torch.equal(g_small, g_big)
    for k in range(2):
        d1, t1, g1 = run(np.ascontiguousarray(idx[k:k + 1]), nb[k:k + 1],
                         np.ascontiguousarray(theta[k:k + 1]))
        assert torch.equal(d1[0], d_big[k]) and torch.equal(t1[0], t_big[k])
        assert torch.equal(g1[0], g_big[k])


def test_collapsed_matches_jax():
    """SoftmaxBound.collapsed (one matmul a chain) against the reference's
    per chain, at Kc = 512, D = 32, with each chain's own statistics too."""
    x, t, xi, _, _, theta = _wide_inputs(seed=2)
    jdata = jbounds.GLMData(jnp.asarray(x), jnp.asarray(t), jnp.asarray(xi))
    jstats = jbounds.SoftmaxBound.suffstats(jdata)
    stats = convert.collapsed_stats(*jax.device_get(jstats), device=CPU)
    th = torch.from_numpy(theta)
    got = tbounds.SoftmaxBound.collapsed(th, stats)
    own = tbounds.CollapsedStats(*(a.expand((2,) + a.shape).clone()
                                   for a in stats))
    got_own = tbounds.SoftmaxBound.collapsed(th, own)
    for i in range(2):
        want = float(jbounds.SoftmaxBound.collapsed(jnp.asarray(theta[i]),
                                                    jstats))
        np.testing.assert_allclose(float(got[i]), want, rtol=1e-5)
    assert torch.equal(got, got_own)


def test_collapsed_value_and_gradient_batch_invariant_at_lm_width():
    assert_softmax_collapsed_batch_invariant(512, 64, CPU)


# ---------------------------------------------------------------------------
# The FlyMC step over the head, and the contracts
# ---------------------------------------------------------------------------


@functools.cache
def _jax_tuned():
    jm = _pair("llama3.2-3b").jax_glm()
    th = jm.map_estimate(jax.random.key(2), steps=40, lr=0.05)
    return jm.map_tuned(th), th


def test_one_lastlayer_step_matches_jax_kernel_engines():
    """One MALA FlyMC step over the reduced llama3.2-3b head (Kc = 512,
    D = 128, N = 64) with the example's settings on both packages' kernel
    engines (the port's plain versions on the CPU, the reference's Pallas
    kernels in interpret mode), two chains batched in the port."""
    model, th_map = _jax_tuned()
    kw = dict(kernel="mala", capacity=64, cand_capacity=64, q_db=0.05)
    spec = jflymc.FlyMCSpec(bound=model.bound, log_prior=model.log_prior,
                            backend="pallas", z_backend="fused", **kw)
    init = jax.jit(lambda k: jflymc.init_chain_state(
        spec, model.data, model.stats, th_map, k, step_size=1e-3))
    step_fn = jax.jit(lambda st: jflymc.flymc_step(spec, model.data,
                                                   model.stats, st))
    margin = jax.jit(lambda st: _log_ratio_margin(spec, model, st))
    states, outs, margins = [], [], []
    for seed in (3, 4):
        st = init(jax.random.key(seed))
        margins.append(float(margin(st)))
        states.append(_to_port(st))
        outs.append(step_fn(st))
    assert min(margins) > 1e-4, margins

    d = jax.device_get(model.data)
    tdata = convert.glm_data(d.x, d.t, d.xi, device=CPU)
    tstats = convert.collapsed_stats(*jax.device_get(model.stats), device=CPU)
    tspec = tflymc.FlyMCSpec(
        bound=tbounds.SoftmaxBound(),
        log_prior=partial(tbounds.gaussian_log_prior, scale=PRIOR), **kw)
    batched = {k: np.stack([s[k] for s in states]) for k in states[0]}
    tstate = convert.flymc_state(**batched, device=CPU, batched=True)
    new, stats = tflymc.flymc_step(tspec, tdata, tstats, tstate)
    for i, (ref, ref_stats) in enumerate(outs):
        ref = jax.device_get(ref)
        np.testing.assert_array_equal(new.bright.arr[i].numpy(),
                                      ref.bright.arr)
        assert int(new.bright.num[i]) == int(ref.bright.num)
        np.testing.assert_allclose(new.sampler.theta[i].numpy(),
                                   ref.sampler.theta, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(new.delta_full[i].numpy(), ref.delta_full,
                                   rtol=1e-5, atol=1e-5)
        assert int(stats.lik_queries[i]) == int(ref_stats.lik_queries)
        assert bool(stats.overflow[i]) == bool(ref_stats.overflow)


@functools.cache
def _port_map():
    """The port's own lastlayer GLM on a seed-initialised reduced
    llama3.2-3b, MAP-tuned, and its θ_MAP."""
    lm = T.init_model(get_reduced("llama3.2-3b"), 0, CPU, torch.float32)
    toks = torch.randint(0, 512, (2, 33),
                         generator=torch.Generator().manual_seed(5))
    m = lastlayer_glm(lm, toks, prior_scale=PRIOR)
    theta_map = m.map_estimate(jr.key(6, device=CPU), steps=40)
    return m.map_tuned(theta_map), theta_map


def _port_tuned():
    return _port_map()[0]


def _alg(model, cap):
    return api.firefly(model, kernel="mala", capacity=cap, cand_capacity=cap,
                       q_db=0.05, step_size=1e-4, adapt_target="auto",
                       device=CPU)


def test_lastlayer_chain_is_capacity_invariant():
    """MALA over the head at capacity 4 (overflow re-runs, grown buffers)
    is bitwise the run at capacity 64, and the chain moves."""
    model = _port_tuned()
    big = api.sample(_alg(model, 64), jr.key(7, device=CPU), 12,
                     num_chains=2, device=CPU)
    small = api.sample(_alg(model, 4), jr.key(7, device=CPU), 12,
                       num_chains=2, chunk_size=5, device=CPU)
    assert small.algorithm.spec.capacity > 4 and small.steps_run > 12
    assert torch.equal(big.theta, small.theta)
    for a, b in zip(big.stats, small.stats):
        assert torch.equal(a, b)
    assert bool((big.theta[:, 1:] != big.theta[:, :-1]).any())


def test_lastlayer_chains_batched_equal_solo():
    model = _port_tuned()
    alg = _alg(model, 64)
    key = jr.key(9, device=CPU)
    both = api.sample(alg, key, 10, num_chains=2, device=CPU)
    k_init, k_steps = jr.split(key)
    init_keys, chain_keys = jr.split(k_init, 2), jr.split(k_steps, 2)
    for c in range(2):
        st = alg.init(init_keys[c:c + 1], alg.default_position[None])
        one = api.sample(alg, chain_keys[c], 10, init_state=st, device=CPU)
        assert torch.equal(one.theta[0], both.theta[c])


def test_lastlayer_chain_off_the_tangency_does_flymc_work():
    """From θ_MAP moved by ε0·noise, with ε0 set for a mean Böhning gap of
    ~0.05 a token (¼·Kc·|x|²·ε0² over flat logits) and the step at ε0/4,
    as the card smoke starts its full-width chain: tokens are bright, every
    step accepts or not but θ moves, and the final bright set's stored δ is
    the plain version's (1e-5 absolute and relative) and well above 0."""
    from repro_torch.core import brightness
    from repro_torch.kernels.bright_glm.ref import bright_glm_ref

    model, theta_map = _port_map()
    x2 = float(model.data.x.square().sum(1).mean())
    eps0 = (0.2 / (model.theta_shape[0] * x2)) ** 0.5
    theta0 = theta_map + eps0 * jr.normal(
        jr.key(8, device=CPU), (2, *model.theta_shape))
    alg = api.firefly(model, kernel="mala", capacity=64, cand_capacity=64,
                      q_db=0.05, step_size=0.25 * eps0, adapt_target="auto",
                      backend="pallas", z_backend="fused", device=CPU)
    tr = api.sample(alg, jr.key(7, device=CPU), 10, num_chains=2,
                    init_position=theta0, device=CPU)
    assert bool((tr.stats.n_bright > 0).all())
    assert float(tr.stats.accept_prob.mean()) > 0.5
    assert bool((tr.theta[:, -1] != theta0).any())
    fs, spec = tr.final_state, tr.algorithm.spec
    idx, mask = brightness.bright_buffer(fs.bright, spec.capacity)
    d_ref, _ = bright_glm_ref(model.data.x, model.data.t, model.data.xi, idx,
                              fs.bright.num, fs.sampler.theta,
                              family="softmax",
                              **spec.bound.fused_kernel_kwargs())
    assert float(d_ref[mask].min()) > 1e-3
    torch.testing.assert_close(fs.sampler.aux[mask], d_ref[mask], rtol=1e-5,
                               atol=1e-5)
