"""Port parity: the rwkv6 training step of repro_torch against the JAX
package, on the reduced rwkv6-7b twin (2 layers, d_model 128, 4 heads × 32,
vocab 512), in float32, at S = 1,024 tokens: two 512-token time chunks of
eight 64-step WKV chunks each, so the WKV state and both token shifts carry
across time chunks, and the gradient flows back through them (the port's
``RWKV6Scan`` backward, ``rwkv6_bwd_ref`` on the CPU; the reference
differentiates its jnp ``_wkv_chunk``).

Both packages start from the same weights: JAX ``init_model(key 0)`` with
its zero-initialised token-shift mixes ``mu``, decay LoRA ``wb`` and bonus
``u`` overwritten by seeded values (so that every path of the time mix
carries a gradient) → numpy → :func:`repro_torch.convert.lm_params`.
Batches are drawn with numpy and handed to both. Tolerances are
``tests/test_torch_train.py``'s: the loss, ``grad_norm`` and ``lr`` at 1e-5
relative; gradients at 1e-4 relative plus 1e-4 of each tensor's largest
value; parameters after an AdamW step at 1e-4 relative and absolute (that
file's header says why the absolute 1e-4 is needed).
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
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
from repro_torch.models import transformer as T

ARCH = "rwkv6-7b"
B, S = 2, 1024
PEAK_LR = 1e-3


@functools.cache
def _reference():
    jcfg = jax_get_reduced(ARCH)
    params, specs = JT.init_model(jcfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    mix = params["blocks"]["slot0"]["mix"]
    for name, draw in (("mu", lambda s: rng.uniform(0.0, 1.0, s)),
                       ("wb", lambda s: 0.3 * rng.normal(size=s)),
                       ("u", lambda s: 0.5 * rng.normal(size=s))):
        mix[name] = jnp.asarray(draw(mix[name].shape).astype(np.float32))
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
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def test_loss_and_every_gradient_match_jax(monkeypatch):
    """``loss_fn`` and the gradient of every parameter against
    ``jax.value_and_grad`` of the reference's ``loss_fn``; the port's WKV
    backward runs once per layer and time chunk."""
    jcfg, specs, params_np = _reference()
    b = _batch(1)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, specs, jcfg, Par(), _jax_batch(b),
                             dtype=jnp.float32, remat=False),
        has_aux=True)(jax.tree.map(jnp.asarray, params_np))
    calls = []
    plain = rwkv_ops.rwkv6_bwd_ref
    monkeypatch.setattr(rwkv_ops, "rwkv6_bwd_ref",
                        lambda *a: calls.append(1) or plain(*a))
    model = _port_model(params_np)
    loss, met = T.loss_fn(model, _torch_batch(b), torch.float32)
    loss.backward()
    assert len(calls) == model.cfg.n_layers * 2  # two time chunks a layer
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["nll"].detach()), float(jmet["nll"]),
                               rtol=1e-5)
    want = dict(convert.lm_params(jax.device_get(jgrads), model.cfg,
                                  "cpu").named_parameters())
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, want[name].detach().numpy())


@functools.cache
def _jax_step(warmup_steps):
    jcfg, specs, _ = _reference()
    step, _ = JT.make_train_step(jcfg, {}, Par(), dtype=jnp.float32,
                                 remat=False, peak_lr=PEAK_LR,
                                 warmup_steps=warmup_steps)
    return jax.jit(step)


@pytest.mark.parametrize("warmup_steps", [2, 0])
def test_three_train_steps_match_jax(warmup_steps):
    """Three steps on the same batches, as
    ``tests/test_torch_train.py::test_three_train_steps_match_jax``: loss,
    nll, grad_norm and lr before each update, and every parameter after
    it. The batches are seeds 10, 11 and 13. Seed 12 (that file's third
    batch) puts this twin's float32 gradient at an ill-conditioned point:
    at the initial parameters the reference's gradients lie up to 1.9e-4
    (relative, by norm) from a float64 evaluation and the port's up to
    6.3e-5 (plain autograd's as the port's), and the two gradient norms
    1.5e-5 apart, past the 1e-5 this test holds them to."""
    _, _, params_np = _reference()
    jstep = _jax_step(warmup_steps)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jopt = JT.init_opt(jparams)
    model = _port_model(params_np)
    opt = T.init_opt(model)
    step = T.make_train_step(model.cfg, dtype=torch.float32, peak_lr=PEAK_LR,
                             warmup_steps=warmup_steps)
    want_lr = ([0.0, PEAK_LR / 2, PEAK_LR] if warmup_steps == 2
               else [PEAK_LR] * 3)
    for i in range(3):
        b = _batch((10, 11, 13)[i])
        jparams, jopt, jmet = jstep(jparams, jopt, _jax_batch(b))
        met = step(model, opt, _torch_batch(b))
        for k in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-5, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(float(met["lr"]), want_lr[i], rtol=1e-6)
        ref = dict(convert.lm_params(jax.device_get(jparams), model.cfg,
                                     "cpu").named_parameters())
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       ref[name].detach().numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
    assert int(opt.step) == int(jopt.step) == 3
