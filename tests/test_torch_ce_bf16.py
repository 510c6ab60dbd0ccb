"""Port parity in bfloat16: the model and its training loss are the
reference's.

The reference (JAX on the CPU) is compiled with ``xla_allow_excess_precision``
off, so that XLA rounds every bfloat16 op as the program writes it. With the
default (on), XLA may keep float32 through a fused chain of bf16 ops, and
what it keeps depends on how it fuses: the reference's own ``loss_fn``
compiled both ways moves 84% of the reduced model's final hidden entries
by an ulp and its gradients by up to 4.3% of their largest value
(``test_reference_rounding_depends_on_xla_excess_precision`` prints them),
so no port can follow the default more closely than that.

The reference's bf16 ``ce_loss_tp`` rounds every logit to bfloat16 before
its logsumexp (``_vp_ce_chunk``: ``(xi @ head).astype(float32)`` of a bf16
dot); so does its ``fused_ce_ref`` on bf16 inputs. The port's
``ce_loss_tp`` takes the same logits through ``fused_ce``'s
``round_logits`` mode (on the CPU the plain ``fused_ce_ref``), and its
backward already differentiates them. The ``fused_ce`` mode without
rounding (float32 products, the TPU kernel's function) is a different
function in bf16: ``test_f32_products_mode_misses_the_bf16_reference``
shows that it misses the reference by more than the tolerance the rounding
mode meets. ``jax.nn.gelu`` in bf16 rounds each of its ops to bfloat16;
``F.gelu`` rounds once: ``test_gelu_rounds_as_the_reference`` shows the
difference the port's gelu removes.

Tolerances:
- per-token NLL: 1e-5·(1 + |nll|) on at least 99% of the tokens (a float32
  logsumexp in another order), and on every token one bf16 ulp of its
  largest |logit| (the two float32 dots may round a logit to neighbouring
  bfloat16 values);
- Σ NLL, what ``ce_loss_tp`` returns: 1e-5 relative plus one bf16 ulp of
  the largest |logit|;
- dx and dhead at the layer: 1e-2 relative plus 1e-3 of the largest value
  (dlogits are cast to bfloat16 on both sides; a one-ulp flip of one moves a
  gradient entry by 2^-8 of that term);
- gelu, each block on the reference's input, and each sublayer's output and
  VJP (same input and cotangent): bitwise equal on all but 1% of the
  entries, the rest within one bf16 ulp of the largest |value|. A float32
  dot summed in another order now and then lands on the other side of a
  bf16 rounding boundary; a value rounded at another place differs in
  about 40% of the entries (gelu itself: all but 0.1%). Two gradients are
  summed otherwise by the reference: the conv kernel's over (B, S) in
  bfloat16 (the transpose of a bf16 broadcast; the port sums in float32):
  2e-2 of the largest value; Λ's, in float32 in another order: 1e-5 of the
  largest value;
- ``loss_fn`` on the reduced model: the loss to 5e-4 relative; each
  gradient within 0.05 of its largest value and 0.03 in relative Frobenius
  norm. The rounding flips above (up to 0.11% of a block's outputs on the
  same input) compound through six layers: the loss agrees to 6.8e-5 /
  2.6e-4 and the gradients to 2.0 / 3.2% of their largest value, 1.6 /
  2.0% in norm (batches 1 / 2). The port against itself with d_model
  permuted (the same function, every sum over it in another order) differs
  by 1.6% and 1.0% (batch 1). A missing or wrong term is off by O(1).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.distributed.par import Par
from repro.kernels.fused_ce.ref import fused_ce_ref as jax_fused_ce_ref
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.kernels.fused_ce import ops
from repro_torch.kernels.fused_ce.ref import fused_ce_ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCH = "recurrentgemma-9b"
B, S = 2, 32


@functools.cache
def _reference():
    jcfg = jax_get_reduced(ARCH)
    params, specs = JT.init_model(jcfg, jax.random.key(0))
    return jcfg, specs, jax.device_get(params)


def _layer_inputs(seed, scale=3.0):
    """x (B, S, d) bfloat16 values as float32, head (d, V) float32, labels
    (B, S) int32; logits of std ~``scale``."""
    jcfg, _, _ = _reference()
    d, vp = jcfg.d_model, jcfg.padded_vocab()
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    head = (scale * rng.normal(size=(d, vp)) / np.sqrt(d)).astype(np.float32)
    lab = rng.integers(0, vp, (B, S)).astype(np.int32)
    return x, head, lab


def _bf16_ulp(a):
    """One bfloat16 ulp at |a| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


def _max_abs_logit(x, head):
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ head.astype(
        jnp.bfloat16).astype(np.float64)
    return np.abs(logits).max(-1)


def _jax_token_nll(x, head, lab):
    """Per-token NLL of the reference's bf16 CE chunk, one token a call."""
    jcfg, _, _ = _reference()
    hb = jnp.asarray(head).astype(jnp.bfloat16)
    one = lambda xi, li: JL._vp_ce_chunk(xi[None, None], li[None, None], hb,
                                         jcfg.padded_vocab(), 0, ())
    xt = jnp.asarray(x).astype(jnp.bfloat16).reshape(-1, x.shape[-1])
    return np.asarray(jax.vmap(one)(xt, jnp.asarray(lab).reshape(-1)))


def _port_token_nll(x, head, lab, round_logits):
    tx = torch.from_numpy(x).bfloat16().reshape(-1, x.shape[-1])
    return ops.fused_ce(tx, torch.from_numpy(head).bfloat16(),
                        torch.from_numpy(lab).long().reshape(-1),
                        round_logits=round_logits).numpy()


def _nll_misses(got, want, max_logit):
    """(tokens beyond 1e-5·(1 + |nll|), tokens beyond one bf16 ulp of
    their largest |logit|)."""
    err = np.abs(got - want)
    return (int((err > 1e-5 * (1 + np.abs(want))).sum()),
            int((err > _bf16_ulp(max_logit)).sum()))


@pytest.mark.parametrize("seed,scale", [(0, 3.0), (1, 1.0), (2, 8.0)])
def test_round_logits_matches_jax_bf16_ce_per_token(seed, scale):
    """The plain rounding mode against the reference's bf16 CE chunk
    (``_vp_ce_chunk``) and its bf16 ``fused_ce_ref``, token by token."""
    x, head, lab = _layer_inputs(seed, scale)
    got = _port_token_nll(x, head, lab, round_logits=True)
    max_logit = _max_abs_logit(x, head)
    for want in (_jax_token_nll(x, head, lab),
                 np.asarray(jax_fused_ce_ref(
                     jnp.asarray(x).astype(jnp.bfloat16).reshape(B * S, -1),
                     jnp.asarray(head).astype(jnp.bfloat16),
                     jnp.asarray(lab).reshape(-1)))):
        beyond_f32, beyond_ulp = _nll_misses(got, want, max_logit)
        assert beyond_f32 <= 0.01 * got.size and beyond_ulp == 0


def test_ce_loss_tp_bf16_matches_jax_with_gradients():
    """The port's ``ce_loss_tp`` in bf16 against the reference's on the same
    x, head and labels: Σ NLL, dx and dhead."""
    jcfg, specs, _ = _reference()
    x, head, lab = _layer_inputs(3)

    def jloss(xx, hh):
        total, _ = JL.ce_loss_tp(xx, jnp.asarray(lab), {"head": hh},
                                 specs["embed"], jcfg, Par())
        return total

    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want, (wdx, wdh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jx, jnp.asarray(head))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    total, count = L.ce_loss_tp(tx, torch.from_numpy(lab).long(),
                                types.SimpleNamespace(head=th),
                                get_reduced(ARCH))
    total.backward()
    assert count == B * S
    tol = 1e-5 * abs(float(want)) + _bf16_ulp(_max_abs_logit(x, head).max())
    assert abs(float(total.detach()) - float(want)) <= tol
    for got, ref in ((tx.grad.float(), wdx.astype(jnp.float32)), (th.grad, wdh)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-2,
                                   atol=1e-3 * np.abs(ref).max())


NO_EXCESS = {"xla_allow_excess_precision": False}
LOSS_RTOL, GRAD_MAX, GRAD_FRO = 5e-4, 0.05, 0.03


def _compiled(fn, *args, options=NO_EXCESS):
    """``fn(*args)`` jitted and compiled with the XLA ``options``."""
    return jax.jit(fn).lower(*args).compile(options)(*args)


def _t(a):
    """A JAX array (any dtype) as a torch bfloat16 tensor."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(
        jnp.float32))).bfloat16()


def _assert_rounds_alike(got, ref, name, frac=0.01):
    """``got`` equals ``ref`` bitwise on all but ``frac`` of the entries and
    within one bf16 ulp of the largest |ref| on the rest."""
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    err = np.abs(got - ref)
    differ = float(np.mean(err > 0))
    ulp = _bf16_ulp(np.abs(ref).max())
    print(f"{name}: {differ:.4f} apart, max {float(err.max() / ulp):.3g} ulp")
    assert differ <= frac, (name, differ)
    assert err.max() <= ulp, (name, float(err.max() / ulp))


@functools.cache
def _port_model():
    _, _, params_np = _reference()
    model = convert.lm_params(params_np, get_reduced(ARCH), "cpu")
    return model.requires_grad_(True)


def _batch(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_loss_and_grads(seed, options=NO_EXCESS):
    jcfg, specs, params_np = _reference()
    jb = {k: jnp.asarray(v) for k, v in _batch(seed).items()}
    f = jax.value_and_grad(
        lambda p: JT.loss_fn(p, specs, jcfg, Par(), jb, dtype=jnp.bfloat16,
                             remat=False), has_aux=True)
    (loss, _), grads = _compiled(f, jax.tree.map(jnp.asarray, params_np),
                                 options=options)
    return float(loss), convert.lm_params(jax.device_get(grads),
                                          get_reduced(ARCH), "cpu")


def _port_loss_and_grads(model, seed):
    model.zero_grad(set_to_none=True)
    loss, _ = T.loss_fn(model, {k: torch.from_numpy(v.astype(np.int64))
                                for k, v in _batch(seed).items()},
                        torch.bfloat16)
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy().copy()
                                  for n, p in model.named_parameters()}


def _grad_gaps(got, want):
    """{name: (max|Δ| / max|want|, ‖Δ‖ / ‖want‖)}."""
    return {n: (float(np.abs(g - want[n]).max() / np.abs(want[n]).max()),
                float(np.linalg.norm(g - want[n]) / np.linalg.norm(want[n])))
            for n, g in got.items()}


def test_gelu_rounds_as_the_reference():
    """The port's gelu against ``jax.nn.gelu`` in bf16, value and VJP: each
    op rounded to bfloat16 where the reference rounds it. ``F.gelu``
    (float32 inside, one rounding) misses in a large share of entries."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(3 * rng.normal(size=(64, 256))).astype(jnp.bfloat16)
    g = jnp.asarray(rng.normal(size=(64, 256))).astype(jnp.bfloat16)

    def vjp(xx, gg):
        y, pull = jax.vjp(jax.nn.gelu, xx)
        return y, pull(gg)[0]

    y, dx = _compiled(vjp, x, g)
    tx = _t(x).requires_grad_()
    ty = L._gelu(tx)
    ty.backward(_t(g))
    _assert_rounds_alike(ty, y, "gelu", frac=1e-3)
    _assert_rounds_alike(tx.grad, dx, "gelu vjp", frac=1e-3)
    once = torch.nn.functional.gelu(_t(x), approximate="tanh").float().numpy()
    apart = float(np.mean(once != np.asarray(y.astype(jnp.float32))))
    print(f"F.gelu: {apart:.4f} apart")
    assert apart > 0.2


@functools.cache
def _jax_block_io(seed):
    """The reference's embedding and each block's output, bf16, in one
    compiled forward."""
    jcfg, specs, params_np = _reference()
    slots = sorted(params_np["blocks"])
    wss = {s: jax.tree.map(JT._unstack_spec, specs["blocks"][s],
                           is_leaf=lambda q: hasattr(q, "tp_dim"))
           for s in slots}
    toks = jnp.asarray(_batch(seed)["tokens"])

    def forward(p):
        x = JL.embed_tokens(toks, p["embed"], specs["embed"], jcfg, Par(),
                            jnp.bfloat16, False)
        xs = [x]
        for g in range(jcfg.n_layers // len(slots)):
            for si, s in enumerate(slots):
                x = JT._block_fwd(x, JT._tree_index(p["blocks"][s], g),
                                  wss[s], jcfg, Par(),
                                  jcfg.block_pattern[si])[0]
                xs.append(x)
        return xs

    return _compiled(forward, jax.tree.map(jnp.asarray, params_np))


@pytest.mark.parametrize("layer", range(6))
def test_bf16_block_matches_jax_on_its_input(layer):
    """Each block of the reduced model in bf16 on the reference's input to
    it, against the reference's output (rglru, rglru, attn, twice)."""
    model = _port_model()
    xs = _jax_block_io(1)
    if layer == 0:
        ids = torch.from_numpy(_batch(1)["tokens"].astype(np.int64))
        _assert_rounds_alike(L.embed_tokens(ids, model.embed, torch.bfloat16),
                             xs[0], "embed", frac=0.0)
    with torch.no_grad():
        y, _ = T._block_fwd(_t(xs[layer]), model.blocks[layer], model.cfg)
    _assert_rounds_alike(y, xs[layer + 1], f"block {layer}")


@pytest.mark.parametrize("sub", ["norm", "rglru", "attn", "mlp"])
def test_bf16_sublayer_vjp_matches_jax(sub):
    """One sublayer's output and VJP in bf16 on the same input and
    cotangent: dx and every weight's gradient."""
    jcfg, specs, params_np = _reference()
    model = _port_model()
    model.zero_grad(set_to_none=True)
    layer = 2 if sub == "attn" else 0
    slot = sorted(params_np["blocks"])[layer]
    w = JT._tree_index(jax.tree.map(jnp.asarray, params_np["blocks"][slot]),
                       0)
    ws = jax.tree.map(JT._unstack_spec, specs["blocks"][slot],
                      is_leaf=lambda q: hasattr(q, "tp_dim"))
    blk = model.blocks[layer]
    jax_fn, port_fn, key, mod = {
        "norm": (lambda x, p: JL.apply_norm(x, p, ws["ln1"], jcfg.norm,
                                            jnp.bfloat16),
                 lambda x: L.apply_norm(x, blk.ln1, torch.bfloat16), "ln1",
                 blk.ln1),
        "rglru": (lambda x, p: JL.rglru_mix(x, p, ws["mix"], jcfg, Par()),
                  lambda x: L.rglru_mix(x, blk.mix, model.cfg), "mix",
                  blk.mix),
        "attn": (lambda x, p: JL.attn_tp(x, p, ws["attn"], jcfg, Par(),
                                         window=jcfg.local_attn_window),
                 lambda x: L.attn_tp(x, blk.mix, model.cfg,
                                     window=model.cfg.local_attn_window),
                 "attn", blk.mix),
        "mlp": (lambda x, p: JL.mlp_tp(x, p, ws["ffn"], jcfg, Par()),
                lambda x: L.mlp_tp(x, blk.ffn), "ffn", blk.ffn),
    }[sub]
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=(B, S, jcfg.d_model))).astype(
        jnp.bfloat16)
    dy = jnp.asarray(1e-3 * rng.normal(size=(B, S, jcfg.d_model))).astype(
        jnp.bfloat16)

    def vjp(xx, p):
        y, pull = jax.vjp(jax_fn, xx, p)
        return y, pull(dy)

    y, (dx, dw) = _compiled(vjp, x, w[key])
    tx = _t(x).requires_grad_()
    ty = port_fn(tx)
    ty.backward(_t(dy))
    _assert_rounds_alike(ty, y, f"{sub} y")
    _assert_rounds_alike(tx.grad, dx, f"{sub} dx")
    for name, p in mod.named_parameters():
        ref = np.asarray(dw[name])
        if name in ("conv", "lam"):
            # conv: the reference sums over (B, S) in bf16; lam: in float32
            # in another order
            tol = 2e-2 if name == "conv" else 1e-5
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                       atol=tol * np.abs(ref).max())
        else:
            _assert_rounds_alike(p.grad, ref, f"{sub} d{name}")


@pytest.mark.parametrize("seed", [1, 2])
def test_bf16_loss_and_every_gradient_match_jax(seed):
    """``loss_fn`` and every gradient on the reduced model in bf16 against
    the reference's ``loss_fn(dtype=bfloat16)``."""
    want_loss, want = _jax_loss_and_grads(seed)
    want = {n: p.detach().numpy() for n, p in want.named_parameters()}
    loss, grads = _port_loss_and_grads(_port_model(), seed)
    gaps = _grad_gaps(grads, want)
    print(f"loss rel {abs(loss - want_loss) / abs(want_loss):.3g}, gradient "
          f"max|Δ|/max {max(m for m, _ in gaps.values()):.4f}, ‖Δ‖/‖g‖ "
          f"{max(f for _, f in gaps.values()):.4f}")
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    for name, (m, f) in gaps.items():
        assert m <= GRAD_MAX and f <= GRAD_FRO, (name, m, f)


def test_reference_rounding_depends_on_xla_excess_precision():
    """Why the reference is compiled with excess precision off: with XLA's
    default, its own bf16 loss_fn keeps float32 through fused chains, and
    moves further from itself than the port is from it."""
    jcfg, specs, params_np = _reference()
    jb = {k: jnp.asarray(v) for k, v in _batch(1).items()}
    hidden = lambda p: JT.forward_hidden(p, specs, jcfg, Par(), jb,
                                         dtype=jnp.bfloat16, remat=False)[0]
    jp = jax.tree.map(jnp.asarray, params_np)
    h_default, h_rounded = (
        np.asarray(_compiled(hidden, jp, options=o).astype(jnp.float32))
        for o in ({}, NO_EXCESS))
    default_loss, default = _jax_loss_and_grads(1, options={})
    rounded_loss, rounded = _jax_loss_and_grads(1)
    gaps = _grad_gaps({n: p.detach().numpy()
                       for n, p in default.named_parameters()},
                      {n: p.detach().numpy()
                       for n, p in rounded.named_parameters()})
    differ = float(np.mean(h_default != h_rounded))
    print(f"final hidden entries apart {differ:.3f}, loss rel "
          f"{abs(default_loss - rounded_loss) / rounded_loss:.3g}, gradient "
          f"max|Δ|/max {max(m for m, _ in gaps.values()):.4f}, ‖Δ‖/‖g‖ "
          f"{max(f for _, f in gaps.values()):.4f}")
    assert differ > 0.5


def test_port_summation_order_alone_moves_the_gradients():
    """The port against itself with d_model permuted: the same function,
    every sum over d_model in another order. Its gradients move by the size
    of the gap ``test_bf16_loss_and_every_gradient_match_jax`` allows."""
    cfg = get_reduced(ARCH)
    perm = torch.from_numpy(np.random.default_rng(99).permutation(
        cfg.d_model))
    rows = ("wx", "wgate", "wa", "wi", "wq", "wk", "wv", "w1", "head")
    cols = ("wo", "w2", "table")

    def permute(name, a, p):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale" or leaf in rows:
            return a[p]
        return a[:, p] if leaf in cols else a

    base = _port_model()
    other = convert.lm_params(_reference()[2], cfg, "cpu")
    with torch.no_grad():
        for (name, a), b in zip(base.named_parameters(), other.parameters()):
            b.copy_(permute(name, a, perm))
    other.requires_grad_(True)
    loss, grads = _port_loss_and_grads(base, 1)
    loss_p, grads_p = _port_loss_and_grads(other, 1)
    inv = torch.argsort(perm)
    gaps = _grad_gaps(grads, {n: permute(n, torch.from_numpy(g), inv).numpy()
                              for n, g in grads_p.items()})
    worst_max = max(m for m, _ in gaps.values())
    worst_fro = max(f for _, f in gaps.values())
    print(f"loss rel {abs(loss - loss_p) / loss:.3g}, gradient max|Δ|/max "
          f"{worst_max:.4f}, ‖Δ‖/‖g‖ {worst_fro:.4f}")
    np.testing.assert_allclose(loss, loss_p, rtol=LOSS_RTOL)
    assert 0 < worst_max <= GRAD_MAX and 0 < worst_fro <= GRAD_FRO


def test_f32_products_mode_misses_the_bf16_reference():
    """The fault the rounding mode repairs: in bf16 the float32-products
    mode (the TPU kernel's function) is not the reference's loss: most of
    its tokens miss the reference's NLL by more than the per-token
    tolerance the rounding mode meets."""
    x, head, lab = _layer_inputs(0, 8.0)
    want = _jax_token_nll(x, head, lab)
    max_logit = _max_abs_logit(x, head)
    rounded = _port_token_nll(x, head, lab, round_logits=True)
    products = _port_token_nll(x, head, lab, round_logits=False)
    assert _nll_misses(rounded, want, max_logit)[0] <= 0.01 * want.size
    assert _nll_misses(products, want, max_logit)[0] > 0.5 * want.size


def test_round_logits_needs_bf16():
    x, head, lab = _layer_inputs(4)
    with pytest.raises(ValueError, match="round_logits needs bfloat16"):
        ops.lse_and_target(torch.from_numpy(x[0]), torch.from_numpy(head),
                           torch.from_numpy(lab[0]).long(), round_logits=True)
    # the plain form: float32 products rounded to bf16
    tx = torch.from_numpy(x[0]).bfloat16()
    th = torch.from_numpy(head).bfloat16()
    lse, tgt = fused_ce_ref(tx, th, torch.from_numpy(lab[0]).long(),
                            round_logits=True)
    logits = (tx.float() @ th.float()).to(torch.bfloat16).float()
    assert torch.equal(lse, torch.logsumexp(logits, -1))
    assert torch.equal(tgt, logits[torch.arange(S), torch.from_numpy(lab[0]).long()])
