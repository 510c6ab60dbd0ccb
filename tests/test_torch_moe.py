"""Port parity: the MoE layer (capacity-based sort dispatch) of repro_torch
against the JAX package, on the reduced twins of mixtral-8x7b and
arctic-480b (E = 4 experts, top-2, capacity factor 1.25; arctic with its
dense residual FFN), in float32.

Both packages start from the same weights: JAX ``init_model(key 0)`` →
numpy → :func:`repro_torch.convert.lm_params`. Every comparison first
holds the routing 1e-4 away from a tie (the k-th and (k+1)-th router
probabilities of every token), where the two top-k orders may differ.
Tolerances: y at 1e-4 absolute and relative (float32 through two batched
products); ``lb_loss`` at 1e-5; ``drop_frac`` and the set of kept (token,
expert) pairs exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.distributed.par import Par
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

MOE = ("mixtral-8x7b", "arctic-480b")
PAR = Par()
TOL = dict(rtol=1e-4, atol=1e-4)
GAP = 1e-4


class Twin:
    """The same reduced MoE model in both packages."""

    def __init__(self, arch):
        self.jcfg = jax_get_reduced(arch)
        self.cfg = get_reduced(arch)
        params, self.specs = JT.init_model(self.jcfg, jax.random.key(0))
        self.params = params
        self.model = convert.lm_params(jax.device_get(params), self.cfg,
                                       "cpu")

    def jax_ffn(self, layer=0):
        """The reference's ffn weights and specs of one layer."""
        w = jax.tree.map(lambda a: a[layer], self.params["blocks"]["slot0"])
        ws = jax.tree.map(JT._unstack_spec, self.specs["blocks"]["slot0"],
                          is_leaf=lambda s: hasattr(s, "fsdp_dim"))
        return w["ffn"], ws["ffn"]

    def jax_moe_tokens(self, x, layer=0):
        w, _ = self.jax_ffn(layer)
        return JL._moe_tokens(jnp.asarray(x), tuple(
            w[n] for n in ("router", "w1", "w2", "w3")), self.jcfg)


@functools.cache
def _twin(arch):
    return Twin(arch)


@pytest.fixture(params=MOE)
def twin(request):
    return _twin(request.param)


def _tokens(twin, t, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (t, twin.cfg.d_model)).astype(np.float32)


def _hold_from_ties(probs, k):
    """Every token's k-th router probability at least GAP above its
    (k+1)-th: the top-k set is then the same in both packages."""
    p = -np.sort(-np.asarray(probs), axis=-1)
    gap = float((p[:, k - 1] - p[:, k]).min())
    assert gap >= GAP, f"a routing tie within {gap:.3g}"


def _jax_kept(x, router, cfg):
    """The (token, expert) pairs the reference keeps: its routing lines
    (repro/models/layers.py, ``_moe_tokens``) evaluated on their own."""
    t = x.shape[0]
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = int(cfg.moe.capacity_factor * k * t / e)
    cap = max(8, ((cap + 7) // 8) * 8)
    probs = jax.nn.softmax((jnp.asarray(x) @ router).astype(jnp.float32), -1)
    _, expert = jax.lax.top_k(probs, k)
    flat_e = expert.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos = jnp.arange(t * k) - jnp.searchsorted(sorted_e, sorted_e,
                                               side="left")
    ok = np.asarray(pos < cap)
    pairs = zip(np.asarray(order // k)[ok], np.asarray(sorted_e)[ok])
    return {(int(a), int(b)) for a, b in pairs}, np.asarray(probs)


def _port_kept(route, k):
    ok = route["ok"].numpy()
    tok = (route["order"] // k).numpy()[ok]
    sorted_e = route["expert"].reshape(-1)[route["order"]].numpy()[ok]
    return {(int(a), int(b)) for a, b in zip(tok, sorted_e)}


def _check_moe_tokens(twin, x, layer=0):
    """One call in both packages: routing held from ties, then y, the
    kept set, drop_frac and lb_loss. Returns the port's aux."""
    cfg = twin.cfg
    ffn = twin.model.blocks[layer].ffn
    jw, _ = twin.jax_ffn(layer)
    kept, probs = _jax_kept(x, jw["router"], twin.jcfg)
    _hold_from_ties(probs, cfg.moe.top_k)
    y_ref, aux_ref = twin.jax_moe_tokens(x, layer)
    xt = torch.from_numpy(x)
    y, aux = L.moe_tokens(xt, L.moe_weights(ffn, xt.dtype), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    route = L.moe_route(xt, ffn.router, cfg)
    assert _port_kept(route, cfg.moe.top_k) == kept
    np.testing.assert_allclose(route["probs"].numpy(), probs, rtol=1e-6,
                               atol=1e-6)
    assert float(aux["drop_frac"]) == float(aux_ref["drop_frac"])
    np.testing.assert_allclose(float(aux["lb_loss"]),
                               float(aux_ref["lb_loss"]), rtol=0, atol=1e-5)
    return aux


@pytest.mark.parametrize("t,seed", [(4, 1), (64, 2), (203, 3)],
                         ids=["decode-batch", "T64", "T203"])
def test_moe_tokens_matches_reference(twin, t, seed):
    """``moe_tokens`` against ``_moe_tokens`` at a decode step's T = 4
    (capacity 8: nothing drops) and at prefill-like T (203 is not a
    multiple of 8: the capacity rounds up)."""
    _check_moe_tokens(twin, _tokens(twin, t, seed))


def test_moe_tokens_drops_past_capacity(twin):
    """Tokens with a common mean and router column 0 scaled by 2 (signed so
    that the mean raises its logit) crowd expert 0 past its capacity:
    about a tenth of the pairs drop, the same pairs in both packages."""
    scaled = _twin_with_scaled_router(twin.cfg.name)
    aux = _check_moe_tokens(scaled, _tokens(scaled, 128, 4) + 1.0)
    assert float(aux["drop_frac"]) > 0.05


@functools.cache
def _twin_with_scaled_router(arch):
    t = Twin(arch)
    jw = t.params["blocks"]["slot0"]["ffn"]
    f = 2.0 * float(jnp.sign(jw["router"][0, :, 0].sum()))
    jw["router"] = jw["router"].at[0, :, 0].multiply(f)
    with torch.no_grad():
        t.model.blocks[0].ffn.router[:, 0] *= f
    return t


@pytest.mark.parametrize("chunk", [None, 32, 16],
                         ids=["auto", "2-chunks", "4-chunks"])
def test_moe_sp_matches_reference(twin, chunk):
    """``moe_sp`` over (B, S, d) in sequence chunks, each chunk's B·chunk
    tokens one dispatch with its own capacity, against the reference's
    ``moe_sp`` with the same ``chunk`` (and arctic's dense residual);
    the aux is the mean over chunks."""
    x = np.random.default_rng(5).normal(
        0, 1, (2, 64, twin.cfg.d_model)).astype(np.float32)
    w, ws = twin.jax_ffn(1)
    for c0 in range(0, 64, chunk or 64):
        _, probs = _jax_kept(x[:, c0:c0 + (chunk or 64)].reshape(
            -1, twin.cfg.d_model), w["router"], twin.jcfg)
        _hold_from_ties(probs, twin.cfg.moe.top_k)
    y_ref, aux_ref = JL.moe_sp(jnp.asarray(x), w, ws, twin.jcfg, PAR,
                               chunk=chunk)
    ffn = twin.model.blocks[1].ffn
    y, aux = L.moe_sp(torch.from_numpy(x), ffn, twin.cfg, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    assert float(aux["drop_frac"]) == float(aux_ref["drop_frac"])
    np.testing.assert_allclose(float(aux["lb_loss"]),
                               float(aux_ref["lb_loss"]), rtol=0, atol=1e-5)
    assert hasattr(ffn, "dense") == twin.cfg.moe.dense_residual


def test_arctic_dense_residual_is_the_swiglu_beside_the_experts():
    """arctic's ``ffn`` holds a dense swiglu FFN; ``moe_sp`` adds it to the
    experts' output, and without it the result moves."""
    twin = _twin("arctic-480b")
    ffn = twin.model.blocks[0].ffn
    assert set(ffn.dense.defs) == {"w1", "w2", "w3"}
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (2, 16, twin.cfg.d_model)).astype(np.float32))
    y, _ = L.moe_sp(x, ffn, twin.cfg)
    experts, _ = L.moe_tokens(x.reshape(-1, x.shape[-1]),
                              L.moe_weights(ffn, x.dtype), twin.cfg)
    dense = L.mlp_tp(x, ffn.dense, "swiglu")
    torch.testing.assert_close(y, experts.view(x.shape) + dense)
    assert float(dense.abs().max()) > 0.1


@pytest.mark.parametrize("b,s,d", [(4, 6144, 4096), (4, 128, 7168),
                                   (2, 64, 128), (3, 48, 4096),
                                   (1, 100, 8192)])
def test_auto_chunk_is_the_reference_rule(b, s, d):
    """The sequence chunk that fixes the prefill's capacity: mixtral on the
    card (4 × 6,144 → 2 chunks of 3,072), arctic's, the twins', and shapes
    whose halving stops at 16 or meets an odd length."""
    assert L._auto_chunk(b, s, d) == JL._auto_chunk(b, s, d, 1)
    assert L._auto_chunk(4, 6144, 4096) == 3072


def test_forward_hidden_and_aux_match_reference(twin, monkeypatch):
    """The whole forward of the twin (2 MoE layers, the prompt one chunk):
    hidden states at 1e-4, the aux (means over layers) at 1e-5 for
    ``lb_loss`` and 1e-6 for ``drop_frac`` (the reference divides inside
    a fused scan). Each layer's routing is held from ties as the port
    computes it."""
    toks = np.random.default_rng(7).integers(0, 512, (2, 40))
    route, seen = L.moe_route, []

    def held(tokens, router, cfg):
        r = route(tokens, router, cfg)
        _hold_from_ties(r["probs"].numpy(), cfg.moe.top_k)
        seen.append(tokens.shape[0])
        return r

    monkeypatch.setattr(L, "moe_route", held)
    h_ref, aux_ref = JT.forward_hidden(
        twin.params, twin.specs, twin.jcfg, PAR,
        {"tokens": jnp.asarray(toks, jnp.int32)}, dtype=jnp.float32,
        remat=False)
    h, aux = T.forward_hidden(twin.model, torch.from_numpy(toks),
                              torch.float32, aux=True)
    assert seen == [80] * twin.cfg.n_layers  # one dispatch a layer
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **TOL)
    np.testing.assert_allclose(float(aux["lb_loss"]),
                               float(aux_ref["lb_loss"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux["drop_frac"]),
                               float(aux_ref["drop_frac"]), rtol=0,
                               atol=1e-6)


def test_large_leaves_draw_by_leading_slices(monkeypatch):
    """A leaf of ``SLICED_NUMEL`` elements or more (arctic's expert
    matrices) draws its normals one leading slice at a time from the same
    generator, at the same scale; smaller leaves keep their one draw."""
    from repro_torch.models import params as P

    d = P.WDef((3, 8, 5))
    whole = torch.empty(d.shape)
    P.init_param(whole, d, torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    want = torch.randn(d.shape, generator=gen) * (1 / 8**0.5)
    torch.testing.assert_close(whole, want, rtol=0, atol=0)
    monkeypatch.setattr(P, "SLICED_NUMEL", 3 * 8 * 5)
    sliced = torch.empty(d.shape)
    P.init_param(sliced, d, torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    want = torch.stack([torch.randn(8, 5, generator=gen) * (1 / 8**0.5)
                        for _ in range(3)])
    torch.testing.assert_close(sliced, want, rtol=0, atol=0)
