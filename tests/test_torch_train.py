"""Port parity: the recurrentgemma training step of repro_torch against the
JAX package, on the reduced config (6 layers: 2 groups of rglru, rglru,
attn; d_model 128, vocab 512), in float32.

Both packages start from the same weights: JAX ``init_model(key 0)`` →
numpy → :func:`repro_torch.convert.lm_params`; a JAX gradient tree converts
the same way, and ``convert.adamw_state`` carries the AdamW state across.
Batches are drawn with numpy and handed to both. Tolerances: the loss,
``grad_norm`` and ``lr`` at 1e-5 (relative); gradients and AdamW moments at
1e-4 relative plus 1e-4 of each tensor's largest value (float32 through six
layers, sums in another order); parameters at 1e-4 relative and absolute.
The absolute 1e-4 is needed: AdamW's normalised step g/(|g| + eps) turns the
rounding of a near-zero gradient (~1e-8, a float32 sum that cancels, 10–50%
apart between the two packages) into a step of up to lr·O(1), 7e-5 here at
lr 1e-3; a wrong update would be off by up to 2·lr.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.distributed.par import Par
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.launch.train import synthetic_batch, train_reduced
from repro_torch.models import transformer as T
from repro_torch.models.config import check_trainable

ARCH = "recurrentgemma-9b"
B, S = 2, 32
PEAK_LR = 1e-3


@functools.cache
def _reference():
    jcfg = jax_get_reduced(ARCH)
    params, specs = JT.init_model(jcfg, jax.random.key(0))
    return jcfg, specs, jax.device_get(params)


def _batch(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def _port_model(params_np):
    model = convert.lm_params(params_np, get_reduced(ARCH), "cpu")
    model.requires_grad_(True)
    return model


def _close(got, want, tol=1e-4):
    """Within ``tol`` relative plus ``tol`` of the largest value."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _assert_models_close(model, ref_model):
    ref = dict(ref_model.named_parameters())
    names = [n for n, _ in model.named_parameters()]
    assert names == list(ref)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_loss_and_every_gradient_match_jax():
    jcfg, specs, params_np = _reference()
    b = _batch(1)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, specs, jcfg, Par(), _jax_batch(b),
                             dtype=jnp.float32, remat=False),
        has_aux=True)(jax.tree.map(jnp.asarray, params_np))
    model = _port_model(params_np)
    loss, met = T.loss_fn(model, _torch_batch(b), torch.float32)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["nll"].detach()), float(jmet["nll"]),
                               rtol=1e-5)
    grads_as_model = convert.lm_params(jax.device_get(jgrads), model.cfg,
                                       "cpu")
    want = dict(grads_as_model.named_parameters())
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, want[name].detach().numpy())


def _jax_step(warmup_steps):
    jcfg, specs, _ = _reference()
    step, _ = JT.make_train_step(jcfg, {}, Par(), dtype=jnp.float32,
                                 remat=False, peak_lr=PEAK_LR,
                                 warmup_steps=warmup_steps)
    return jax.jit(step)


def _assert_metrics_close(met, jmet):
    for k in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("warmup_steps", [2, 0])
def test_three_train_steps_match_jax(warmup_steps):
    """Three steps on the same batches. With warmup 2 the schedule gives
    lr 0, peak/2, peak (step 1 moves no weight, only the moments); with
    warmup 0 every step moves the weights. Loss, nll, grad_norm and lr
    before each update, and every parameter after it."""
    jcfg, _, params_np = _reference()
    jstep = _jax_step(warmup_steps)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jopt = JT.init_opt(jparams)
    model = _port_model(params_np)
    opt = T.init_opt(model)
    step = T.make_train_step(model.cfg, dtype=torch.float32, peak_lr=PEAK_LR,
                             warmup_steps=warmup_steps)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    want_lr = ([0.0, PEAK_LR / 2, PEAK_LR] if warmup_steps == 2
               else [PEAK_LR] * 3)
    for i in range(3):
        b = _batch(10 + i)
        jparams, jopt, jmet = jstep(jparams, jopt, _jax_batch(b))
        met = step(model, opt, _torch_batch(b))
        _assert_metrics_close(met, jmet)
        np.testing.assert_allclose(float(met["lr"]), want_lr[i], rtol=1e-6)
        _assert_models_close(
            model, convert.lm_params(jax.device_get(jparams), model.cfg,
                                     "cpu"))
        moved = any(not torch.equal(p, init[n])
                    for n, p in model.named_parameters())
        assert moved == (want_lr[i] > 0 or i > 0)
    assert int(opt.step) == int(jopt.step) == 3


def test_resume_from_jax_adamw_state():
    """Two JAX steps, then both packages resume from the JAX parameters and
    AdamWState (``convert.adamw_state``) and take one more step."""
    jstep = _jax_step(2)
    _, _, params_np = _reference()
    jparams = jax.tree.map(jnp.asarray, params_np)
    jopt = JT.init_opt(jparams)
    for i in range(2):
        jparams, jopt, _ = jstep(jparams, jopt, _jax_batch(_batch(20 + i)))
    model = _port_model(jax.device_get(jparams))
    opt = convert.adamw_state(jax.device_get(jopt), model)
    assert int(opt.step) == 2
    step = T.make_train_step(model.cfg, dtype=torch.float32, peak_lr=PEAK_LR,
                             warmup_steps=2)
    b = _batch(22)
    jparams, jopt, jmet = jstep(jparams, jopt, _jax_batch(b))
    met = step(model, opt, _torch_batch(b))
    _assert_metrics_close(met, jmet)
    _assert_models_close(
        model, convert.lm_params(jax.device_get(jparams), model.cfg, "cpu"))
    for name, moments in (("m", jopt.m), ("v", jopt.v)):
        want = dict(convert.lm_params(jax.device_get(moments), model.cfg,
                                      "cpu").named_parameters())
        for n, t in getattr(opt, name).items():
            _close(t, want[n].detach().numpy())


def test_train_reduced_on_cpu():
    model, hist = train_reduced(ARCH, steps=3, batch=2, seq=17,
                                warmup_steps=1, dtype=torch.float32,
                                device="cpu", log_every=100)
    assert len(hist) == 3
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)
    assert [h["lr"] for h in hist][0] == 0.0 and hist[1]["lr"] > 0
    assert all(p.requires_grad for p in model.parameters())


def test_synthetic_batch_copies_seven_back():
    gen = torch.Generator().manual_seed(0)
    b = synthetic_batch(gen, get_reduced(ARCH), 4, 257)
    assert b["tokens"].shape == b["labels"].shape == (4, 256)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    toks = torch.cat([b["tokens"], b["labels"][:, -1:]], 1)
    copied = (toks[:, 7:] == toks[:, :-7]).float().mean()
    # a copy of the base token 7 back (w.p. ½), which itself stayed in
    # place w.p. ½: ~¼ of positions repeat the token 7 back
    assert 0.2 < float(copied) < 0.3
    assert int(toks.max()) < 512 and int(toks.min()) >= 0


def test_unsupported_training_raises():
    """rwkv6 cannot train on the card (its WKV kernel has no backward): it
    raises NotImplementedError naming its ROADMAP item. The card's guard is
    checked without a card. ``remat=True`` builds a step now (remat's
    parity: ``tests/test_torch_train_sp_steps.py``). (Checkpointing the
    training state is ported: ``tests/test_torch_checkpoint.py``.)"""
    rwkv = get_reduced("rwkv6-7b")
    with pytest.raises(NotImplementedError, match="item 9b"):
        check_trainable(rwkv, torch.device("cuda"))
    check_trainable(rwkv, "cpu")  # the plain WKV differentiates
    check_trainable(get_reduced(ARCH), "cuda")
    step = T.make_train_step(get_reduced(ARCH), remat=True)
    assert callable(step)
