"""Port parity: SP-mode training steps of repro_torch against the JAX
package's ``make_train_step``, and ``remat`` within the port, on the
reduced twins (set-up in ``_torch_sp_twins.py``), in float32.

- Three steps (warmup 2: lr 0, peak/2, peak) on the same batches for the
  qwen1.5-110b and arctic-480b twins (bfloat16 AdamW moments, their
  configs' ``opt_dtype``), mixtral-8x7b, whisper-tiny and
  llava-next-mistral-7b: the metrics before each update at 1e-5 relative,
  every parameter after it at 1e-4 relative and absolute (AdamW's
  g/(|g| + eps) turns the rounding of a near-zero gradient into a step of
  up to lr·O(1); ``test_torch_train.py`` says more), float32 moments at
  1e-4 relative plus 1e-4 of their largest value, bfloat16 moments within
  one bfloat16 ulp of the reference's plus that (float32 values a few ulps
  apart may round to either side of a bfloat16 edge). A moment rounded the
  other way at one step stays up to an ulp of its then larger value away
  in the next, so the bfloat16 moments start each step from the
  reference's, bit for bit.
- ``remat=True`` bitwise ``remat=False`` within the port on the CPU: the
  loss, every gradient and every parameter after two steps, for mixtral
  (the MoE's aux returned, not appended, under recompute), whisper (the
  encoder blocks' checkpoints), an 8-layer llama3.2-3b twin (the
  two-level nesting) and rwkv6 at 1,024 tokens (the WKV backward carried
  across time chunks); and how often each group's forward runs (rwkv6 also
  at its card cut of 12 layers).
- The entry point: ``train_reduced`` and ``synthetic_batch`` for the new
  families, and a resume from the reference's bfloat16 ``AdamWState``.

The MoE twins take 2 × 128 tokens a batch and the others 2 × 64, every
MoE dispatch held 1e-4 from a routing tie: the MoE twins' batch seeds
(``SEEDS``) are ones whose dispatches, through all three steps, are.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.launch.train import synthetic_batch, train_reduced
from repro_torch.models import transformer as T
from _torch_sp_twins import (  # noqa: F401  (routing_held_from_ties: autouse)
    PAR,
    close,
    jax_batch,
    metrics_close,
    routing_held_from_ties,
    torch_batch,
    twin,
)

PEAK_LR = 1e-3
WARMUP = 2
SEEDS = {"mixtral-8x7b": 310, "arctic-480b": 60}  # step i's batch: seed + i


@functools.cache
def _jax_step(tw):
    step, _ = JT.make_train_step(tw.jcfg, {}, PAR, dtype=jnp.float32,
                                 remat=False, peak_lr=PEAK_LR,
                                 warmup_steps=WARMUP)
    return jax.jit(step)


def _seq(tw):
    """Tokens a batch row: 128 for the MoE twins, 1,024 for rwkv6 (two
    512-token time chunks: the WKV state and shifts cross them), else 64."""
    if tw.cfg.moe is not None:
        return 128
    return 1024 if "rwkv" in tw.cfg.block_pattern else 64


def _moments_close(got, want, name):
    """float32 moments as :func:`close`; bfloat16 within one bfloat16 ulp
    plus 1e-4 of the largest value."""
    if got.dtype != torch.bfloat16:
        close(got, want, name=name)
        return
    want = want.float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-38))) - 7)
    err = np.abs(got.float().numpy() - want)
    assert (err <= ulp + 1e-4 * np.abs(want).max()).all(), name


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "arctic-480b",
                                  "mixtral-8x7b", "whisper-tiny",
                                  "llava-next-mistral-7b"])
def test_three_train_steps_match_jax(arch):
    tw = twin(arch)
    jstep = _jax_step(tw)
    jparams = tw.jax_params()
    jopt = JT.init_opt(jparams, dtype=tw.jcfg.opt_dtype)
    model = tw.model()
    opt = T.init_opt(model)
    want_dtype = getattr(torch, tw.cfg.opt_dtype)
    assert all(m.dtype == want_dtype for m in opt.m.values())
    step = T.make_train_step(model.cfg, dtype=torch.float32, peak_lr=PEAK_LR,
                             warmup_steps=WARMUP)
    for i in range(3):
        b = tw.batch(SEEDS.get(arch, 10) + i, s=_seq(tw))
        jparams, jopt, jmet = jstep(jparams, jopt, jax_batch(b))
        met = step(model, opt, torch_batch(b))
        metrics_close(met, jmet, keys=("loss", "nll", "lb_loss", "drop_frac",
                                       "grad_norm", "lr"))
        want = tw.as_model(jparams)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
        for key in ("m", "v"):
            want = tw.as_model(jax.tree.map(
                lambda a: a.astype(jnp.float32), getattr(jopt, key)))
            for name, t in getattr(opt, key).items():
                assert t.dtype == want_dtype, name
                _moments_close(t, want[name], f"{key} {name}")
                if t.dtype == torch.bfloat16:
                    t.copy_(want[name])  # exact: bfloat16 values
    assert int(opt.step) == int(jopt.step) == 3


def _two_steps(tw, seed, remat):
    """Loss and gradients of one ``loss_fn`` call, then two train steps;
    returns (loss, grads, metrics of both steps, parameters, AdamW
    state)."""
    model = tw.model()
    b = torch_batch(tw.batch(seed, s=_seq(tw)))
    loss, _ = T.loss_fn(model, b, torch.float32, remat=remat)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    opt = T.init_opt(model)
    step = T.make_train_step(model.cfg, dtype=torch.float32, peak_lr=PEAK_LR,
                             warmup_steps=WARMUP - 1, remat=remat)
    mets = [step(model, opt, torch_batch(tw.batch(seed + i, s=_seq(tw))))
            for i in range(2)]
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return loss.detach(), grads, mets, params, opt


@pytest.mark.parametrize("arch,n_layers", [
    ("mixtral-8x7b", None), ("whisper-tiny", None), ("llama3.2-3b", 8),
    ("rwkv6-7b", None)])
def test_remat_is_bitwise_without_it_on_cpu(arch, n_layers):
    tw = twin(arch, n_layers)
    seed = SEEDS.get(arch, 10)
    off = _two_steps(tw, seed, remat=False)
    on = _two_steps(tw, seed, remat=True)
    assert torch.equal(on[0], off[0])
    for n in off[1]:
        assert torch.equal(on[1][n], off[1][n]), n
    for a, b in zip(on[2], off[2]):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), (a, b)
    for n in off[3]:
        assert torch.equal(on[3][n], off[3][n]), n
        assert torch.equal(on[4].m[n], off[4].m[n])
        assert torch.equal(on[4].v[n], off[4].v[n])


@pytest.mark.parametrize("arch,n_layers", [
    ("mixtral-8x7b", None),  # 2 one-block groups: one level
    ("recurrentgemma-9b", None),  # 2 three-block groups: one level
    ("llama3.2-3b", 8),  # 8 groups: 4 outer checkpoints of 2
    ("rwkv6-7b", None),  # 2 one-block groups: one level
    ("rwkv6-7b", 12),  # 12 groups: 4 outer checkpoints of 3 (rwkv6-7b's
                       # 12-layer training cut on the card)
])
def test_remat_runs_each_group_forward_again(monkeypatch, arch, n_layers):
    """Without ``remat`` each group's forward runs once; with it, once more
    in the backward; nested, an outer checkpoint's recompute runs its
    groups but the last (whose saved tensors its own checkpoint makes)
    once more again. Whisper's encoder blocks run twice under ``remat``."""
    from repro_torch.configs import get_reduced

    cfg = get_reduced(arch, **({} if n_layers is None
                               else {"n_layers": n_layers}))
    model = T.init_model(cfg, 0, "cpu").requires_grad_(True)
    calls = []
    group, encoder = T._group_fwd, T._encoder_block_fwd

    def counted(x, blocks, *rest):
        calls.append(len(blocks))
        return group(x, blocks, *rest)

    monkeypatch.setattr(T, "_group_fwd", counted)
    tok = torch.randint(0, cfg.vocab_size, (2, 32),
                        generator=torch.Generator().manual_seed(0))
    b = {"tokens": tok, "labels": tok}
    n_groups = cfg.n_layers // len(cfg.block_pattern)
    inner = T._inner_groups(n_groups)
    nested = n_groups - n_groups // inner if inner > 1 else 0
    for remat, want in ((False, n_groups), (True, 2 * n_groups + nested)):
        calls.clear()
        T.loss_fn(model, b, torch.float32, remat=remat)[0].backward()
        assert calls == [len(cfg.block_pattern)] * want, (remat, calls)
    enc_calls = []
    monkeypatch.setattr(T, "_encoder_block_fwd",
                        lambda *a: enc_calls.append(1) or encoder(*a))
    wt = twin("whisper-tiny")
    T.loss_fn(wt.model(), torch_batch(wt.batch(4, s=16)), torch.float32,
              remat=True)[0].backward()
    assert len(enc_calls) == 2 * wt.cfg.encoder_layers


def test_resume_from_jax_bf16_adamw_state():
    """Two reference steps on the qwen1.5-110b twin, then both packages
    resume from its parameters and bfloat16 ``AdamWState``
    (``convert.adamw_state`` keeps the moments in bfloat16, bit for bit)
    and take one more step."""
    tw = twin("qwen1.5-110b")
    jstep = _jax_step(tw)
    jparams = tw.jax_params()
    jopt = JT.init_opt(jparams, dtype=tw.jcfg.opt_dtype)
    for i in range(2):
        jparams, jopt, _ = jstep(jparams, jopt, jax_batch(tw.batch(30 + i)))
    model = tw.model(jax.device_get(jparams))
    opt = convert.adamw_state(jax.device_get(jopt), model)
    assert int(opt.step) == 2
    want = tw.as_model(jax.tree.map(lambda a: a.astype(jnp.float32), jopt.m))
    for n, t in opt.m.items():
        assert t.dtype == torch.bfloat16 and torch.equal(t.float(), want[n])
    step = T.make_train_step(model.cfg, dtype=torch.float32, peak_lr=PEAK_LR,
                             warmup_steps=WARMUP)
    b = tw.batch(32)
    jparams, jopt, jmet = jstep(jparams, jopt, jax_batch(b))
    met = step(model, opt, torch_batch(b))
    metrics_close(met, jmet, keys=("loss", "nll", "grad_norm", "lr"))
    want = tw.as_model(jparams)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", ["whisper-tiny", "llava-next-mistral-7b",
                                  "mixtral-8x7b"])
def test_train_reduced_sp_on_cpu(arch):
    """The entry point trains each new family's twin with ``remat``: finite
    losses, a positive gradient norm, and mixtral's balance term in the
    loss."""
    model, hist = train_reduced(arch, steps=2, batch=2, seq=33,
                                warmup_steps=1, dtype=torch.float32,
                                device="cpu", log_every=100, remat=True)
    assert len(hist) == 2
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)
    moe = model.cfg.moe is not None
    assert all((h["lb_loss"] > 0) == moe for h in hist)
    assert all((h["loss"] > h["nll"]) == moe for h in hist)


def test_synthetic_batch_draws_the_frontends():
    """whisper's frames (B, encoder_seq, d) and llava's patches (B,
    patch_positions, d), 0.1·N(0, 1), drawn after the tokens: the tokens
    are those of a config without a frontend from the same seed."""
    from repro_torch.configs import get_reduced

    plain = synthetic_batch(torch.Generator().manual_seed(5),
                            get_reduced("llama3.2-3b"), 3, 33)
    for arch, key in (("whisper-tiny", "frames"),
                      ("llava-next-mistral-7b", "patches")):
        cfg = get_reduced(arch)
        b = synthetic_batch(torch.Generator().manual_seed(5), cfg, 3, 33)
        assert set(b) == {"tokens", "labels", key}
        assert torch.equal(b["tokens"], plain["tokens"])
        rows = cfg.encoder_seq if key == "frames" else cfg.patch_positions
        assert b[key].shape == (3, rows, cfg.d_model)
        assert b[key].dtype == torch.float32
        assert 0.05 < float(b[key].std()) < 0.15
