"""Port parity: the SP-mode training loss of repro_torch against the JAX
package — the dense (llama3.2-3b, qwen2-7b, stablelm-1.6b, qwen1.5-110b),
MoE (mixtral-8x7b, arctic-480b), encoder-decoder (whisper-tiny) and VLM
(llava-next-mistral-7b) reduced twins (2 layers, d_model 128, vocab 512; E
= 4 experts; 2 encoder layers over 32 frames; 16 patch positions), in
float32; and the bf16-moment AdamW update alone.

Set-up in ``_torch_sp_twins.py``: the same numpy weights (random QKV biases
and norm scales) and batches in both packages, every MoE dispatch held 1e-4
from a routing tie. Tolerances: the loss, ``nll``, ``lb_loss`` and
``drop_frac`` at 1e-5 relative; every gradient at 1e-4 relative plus 1e-4
of its largest value (float32 through two layers, sums in another order),
as ``test_torch_train.py``. The batches are 2 × 384 tokens: the loss's
sequence chunk is then 128 (256 halved until it divides 384), three chunks
of (2, 128) rows. The MoE twins take 2 × 128 tokens (still past mixtral's
64-token window, and with pairs dropped at the capacity of 80): at 768
tokens one of the two layers' dispatches lands within 1e-4 of a routing
tie for most batch seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.optim import adamw as jadamw
from repro_torch.kernels.fused_ce import ops as ce_ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from _torch_sp_twins import (  # noqa: F401  (routing_held_from_ties: autouse)
    PAR,
    SP_ARCHS,
    close,
    jax_batch,
    metrics_close,
    routing_held_from_ties,
    torch_batch,
    twin,
)

S, S_MOE = 384, 128


def _loss_and_grads_match(tw, batch, remat):
    """The port's ``loss_fn`` (``remat``) and its gradients against the
    reference's ``loss_fn(dtype=float32, remat=remat)``."""
    (jloss, jmet), jgrads = tw.jax_value_and_grad(remat)(
        tw.jax_params(), jax_batch(batch))
    model = tw.model()
    loss, met = T.loss_fn(model, torch_batch(batch), torch.float32,
                          remat=remat)
    loss.backward()
    metrics_close(met, jmet)
    want = tw.as_model(jgrads)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        close(p.grad, want[name], name=name)
    return met


@pytest.mark.parametrize("arch", SP_ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    """Loss, nll, lb_loss, drop_frac and every gradient (the QKV biases,
    both norms, swiglu, the experts and router through the capacity
    dispatch and ``lb_loss``, arctic's dense residual, whisper's
    cross-attention and encoder, llava's patch rows) against
    ``value_and_grad`` of the reference's loss."""
    tw = twin(arch)
    moe = tw.cfg.moe is not None
    met = _loss_and_grads_match(
        tw, tw.batch(3 if moe else 1, s=S_MOE if moe else S), remat=False)
    if moe:
        assert float(met["lb_loss"].detach()) > 0
        assert float(met["drop_frac"]) > 0
        assert float(met["loss"].detach()) > float(met["nll"].detach())
    else:
        assert torch.equal(met["loss"], met["nll"])


@pytest.mark.parametrize("arch,n_layers", [
    ("mixtral-8x7b", None),  # the MoE's aux under recompute
    ("whisper-tiny", None),  # a checkpoint around each encoder block
    ("llama3.2-3b", 8),  # 8 groups: the two-level nesting (4 × 2)
])
def test_remat_matches_jax_remat(arch, n_layers):
    """The port's ``remat=True`` loss and gradients against the reference's
    ``remat=True`` (its per-group ``jax.checkpoint``, the √L nesting, the
    encoder's checkpoints)."""
    tw = twin(arch, n_layers)
    assert T._inner_groups(tw.cfg.n_layers) == (2 if n_layers else 1)
    _loss_and_grads_match(tw, tw.batch(2, s=128), remat=True)


def test_ce_loss_sp_takes_the_reference_chunks():
    """``ce_loss_sp`` against the reference's (S = 384: chunk 128, three
    chunks): the total and its gradients in x and the head; its one
    ``fused_ce`` call's backward takes chunks of B·c rows, chunk j being
    rows [j·c, (j+1)·c) of every sequence, in order."""
    tw = twin("llama3.2-3b")
    b, d = 2, tw.cfg.d_model
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (b, S, d)).astype(np.float32)
    lab = rng.integers(0, tw.cfg.vocab_size, (b, S)).astype(np.int32)
    embed = tw.params_np["embed"]
    specs = tw.specs["embed"]

    def ref(x, head):
        return JL.ce_loss_sp(x, jnp.asarray(lab), {**embed, "head": head},
                             specs, tw.jcfg, PAR)[0]

    want, (dx_ref, dhead_ref) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(embed["head"]))
    model = tw.model()
    seen = []
    backward = ce_ops.ce_backward

    def recorded(x, w, labels, g, need_x=True, need_w=True, chunk=256):
        seen.append((x.detach().clone(), labels.clone(), chunk))
        return backward(x, w, labels, g, need_x, need_w, chunk)

    xt = torch.from_numpy(x).requires_grad_()
    ce_ops.ce_backward = recorded
    try:
        before = ce_ops.launch_count
        total, count = L.ce_loss_sp(xt, torch.from_numpy(lab).long(),
                                    model.embed, tw.cfg)
        total.backward()
    finally:
        ce_ops.ce_backward = backward
    assert count == b * S
    np.testing.assert_allclose(float(total), float(want), rtol=1e-5)
    close(xt.grad, dx_ref)
    close(model.embed.head.grad, dhead_ref)
    assert ce_ops.launch_count == before  # the CPU runs the plain version
    (rows, labels, chunk), = seen
    c = 128
    assert chunk == b * c
    for j in range(S // c):
        block = rows[j * b * c:(j + 1) * b * c]
        assert torch.equal(block, xt.detach()[:, j * c:(j + 1) * c]
                           .reshape(b * c, d))
        assert torch.equal(labels[j * b * c:(j + 1) * b * c],
                           torch.from_numpy(lab[:, j * c:(j + 1) * c])
                           .reshape(-1).long())


def _ulp_bf16(a):
    """One bfloat16 ulp at each value's magnitude (8 significant bits)."""
    a = np.abs(np.asarray(a, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(a, 1e-38))) - 7)


@pytest.mark.parametrize("with_scale", [False, True])
def test_bf16_adamw_update_matches_reference(with_scale):
    """One AdamW update with bfloat16 moments (step 3 → 4, float32
    parameters) against the reference's ``adamw_update`` on the same
    inputs: the new moments within one bfloat16 ulp (float32 products that
    XLA may contract land on either side of a rounding edge), the
    parameters at 1e-6. The step reads the unrounded moments: a port that
    stepped on the rounded ones would be off by up to lr·2^-8 relative."""
    rng = np.random.default_rng(7)
    shapes = {"a": (64, 48), "b": (300,), "c": (3, 5, 7)}
    p = {n: rng.normal(0, 1, s).astype(np.float32) for n, s in shapes.items()}
    g = {n: rng.normal(0, 1e-2, s).astype(np.float32)
         for n, s in shapes.items()}
    m = {n: rng.normal(0, 1e-3, s).astype(np.float32)
         for n, s in shapes.items()}
    v = {n: rng.uniform(1e-8, 1e-4, s).astype(np.float32)
         for n, s in shapes.items()}
    lr, scale = 1e-3, (0.37 if with_scale else None)
    bf = jnp.bfloat16
    jstate = jadamw.AdamWState(jnp.asarray(3, jnp.int32),
                               {n: jnp.asarray(a, bf) for n, a in m.items()},
                               {n: jnp.asarray(a, bf) for n, a in v.items()})
    jp, jst = jax.jit(lambda g, s, p: jadamw.adamw_update(
        g, s, p, jnp.float32(lr),
        grad_scale=None if scale is None else jnp.float32(scale)))(
        {n: jnp.asarray(a) for n, a in g.items()}, jstate,
        {n: jnp.asarray(a) for n, a in p.items()})
    tb = lambda d: {n: torch.from_numpy(np.asarray(jnp.asarray(a, bf)
                                                   .astype(jnp.float32)))
                    .to(torch.bfloat16) for n, a in d.items()}
    params = {n: torch.from_numpy(a.copy()) for n, a in p.items()}
    state = adamw.AdamWState(torch.tensor(3, dtype=torch.int32), tb(m), tb(v))
    adamw.adamw_update(params, {n: torch.from_numpy(a) for n, a in g.items()},
                       state, torch.tensor(lr),
                       grad_scale=None if scale is None
                       else torch.tensor(scale))
    assert int(state.step) == 4
    for n in shapes:
        for got, want in ((state.m[n], jst.m[n]), (state.v[n], jst.v[n])):
            assert got.dtype == torch.bfloat16
            want = np.asarray(want.astype(jnp.float32))
            err = np.abs(got.float().numpy() - want)
            assert (err <= _ulp_bf16(want)).all(), n
        np.testing.assert_allclose(params[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_slices_are_bitwise_one_pass(monkeypatch, dtype):
    """The update in slices of 1,000 elements (a tensor of 70,000 and one of
    999) gives the bits of one pass over each tensor."""
    gen = torch.Generator().manual_seed(4)
    shapes = {"a": (70, 1000), "b": (999,)}

    def run():
        params = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
        grads = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
        state = adamw.adamw_init(params, dtype)
        for n in shapes:
            state.m[n].copy_(torch.randn(shapes[n], generator=gen))
            state.v[n].copy_(torch.rand(shapes[n], generator=gen))
        adamw.adamw_update(params, grads, state, torch.tensor(1e-3),
                           grad_scale=torch.tensor(0.5))
        return params, state

    gen.manual_seed(4)
    whole = run()
    monkeypatch.setattr(adamw, "SLICE", 1000)
    gen.manual_seed(4)
    sliced = run()
    for (p1, s1), (p2, s2) in [(whole, sliced)]:
        for n in shapes:
            assert torch.equal(p1[n], p2[n])
            assert torch.equal(s1.m[n], s2.m[n]) and s2.m[n].dtype == dtype
            assert torch.equal(s1.v[n], s2.v[n])
