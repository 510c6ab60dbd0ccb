"""Port parity: repro_torch.kernels.bright_glm against the JAX kernel.

The JAX side runs the Pallas kernel in interpret mode, as the reference's
own tests do; the port runs its plain version (CPU tensors). δ to rtol/atol
1e-5, totals to rtol 1e-5, θ-gradients to rtol 1e-4. The CUDA kernel itself
is held against the plain version on the card (``test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bright_glm.ops import bright_glm as jax_bright_glm
from repro_torch.kernels.bright_glm import ops as tops

N, D, KC = 300, 6, 3
KW = {"logistic": {}, "student_t": {"nu": 4.0, "sigma": 1.5}, "softmax": {}}


def _inputs(family, k, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (N, D)).astype(np.float32)
    if family == "softmax":
        t = rng.integers(0, KC, N).astype(np.int32)
        xi = rng.normal(0, 1, (N, KC)).astype(np.float32)
        theta = rng.normal(0, 0.5, (k, KC, D)).astype(np.float32)
    else:
        t = (np.where(rng.random(N) < 0.5, 1.0, -1.0) if family == "logistic"
             else rng.normal(0, 2, N)).astype(np.float32)
        # Keep the bounds away from tightness (δ ≈ 0), where log(expm1 δ)
        # amplifies f32 rounding of δ without bound.
        far = 5.0 if family == "logistic" else np.abs(t) + 5.0
        xi = (far + rng.random(N)).astype(np.float32)
        theta = rng.normal(0, 0.5, (k, D)).astype(np.float32)
    idx = np.stack([rng.permutation(N)[:c] for _ in range(k)]).astype(np.int32)
    idx[:, -3:] = N  # candidate-buffer sentinels
    nb = rng.integers(0, c - 3, k)
    nb[0] = 0 if k > 1 else nb[0]  # an empty chain
    return x, t, xi, idx, nb, theta


def _torch(x, t, xi, idx, nb, theta):
    tt = torch.from_numpy(t.astype(np.int64) if t.dtype == np.int32 else t)
    return (torch.from_numpy(x), tt, torch.from_numpy(xi), torch.from_numpy(idx),
            torch.from_numpy(nb.astype(np.int64)), torch.from_numpy(theta))


def _jax(family, x, t, xi, idx, nb, theta, k):
    return [jax_bright_glm(jnp.asarray(x), jnp.asarray(t), jnp.asarray(xi),
                           jnp.asarray(idx[i]), jnp.int32(nb[i]),
                           jnp.asarray(theta[i]), family=family, interpret=True,
                           **KW[family]) for i in range(k)]


@pytest.mark.parametrize("family", ["logistic", "student_t", "softmax"])
@pytest.mark.parametrize("k,c", [(1, 20), (2, 24)])
def test_delta_and_total_match_jax_kernel(family, k, c):
    args = _inputs(family, k, c)
    ref = _jax(family, *args, k)
    delta, total = tops.bright_glm(*_torch(*args), family=family, **KW[family])
    assert delta.shape == (k, c) and total.shape == (k,)
    for i, (d_ref, t_ref) in enumerate(ref):
        np.testing.assert_allclose(delta[i].numpy(), np.asarray(d_ref),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(total[i].item(), float(t_ref), rtol=1e-5,
                                   atol=1e-5)
    if k > 1:
        assert total[0].item() == 0.0  # n_bright = 0


@pytest.mark.parametrize("family", ["logistic", "student_t", "softmax"])
def test_theta_gradient_matches_jax_grad(family):
    k, c = 2, 24
    x, t, xi, idx, nb, theta = _inputs(family, k, c, seed=1)
    nb = np.array([c - 5, 9])
    tx, tt, txi, tidx, tnb, tth = _torch(x, t, xi, idx, nb, theta)
    th = tth.clone().requires_grad_(True)
    _, total = tops.bright_glm(tx, tt, txi, tidx, tnb, th, family=family,
                               **KW[family])
    (g,) = torch.autograd.grad(total.sum(), th)
    for i in range(k):
        fn = lambda p: jax_bright_glm(
            jnp.asarray(x), jnp.asarray(t), jnp.asarray(xi), jnp.asarray(idx[i]),
            jnp.int32(nb[i]), p, family=family, interpret=True, **KW[family])[1]
        g_ref = np.asarray(jax.grad(fn)(jnp.asarray(theta[i])))
        np.testing.assert_allclose(g[i].numpy(), g_ref, rtol=1e-4, atol=1e-5)


def test_plain_total_and_gradient_are_capacity_invariant():
    x, t, xi, idx, nb, theta = _inputs("logistic", 2, 24, seed=2)
    nb = np.array([17, 20])
    big = np.concatenate([idx, np.full((2, 40), N, np.int32)], axis=1)
    out = []
    for buf in (idx, big):
        tx, tt, txi, tidx, tnb, tth = _torch(x, t, xi, buf, nb, theta)
        th = tth.clone().requires_grad_(True)
        delta, total = tops.bright_glm(tx, tt, txi, tidx, tnb, th)
        (g,) = torch.autograd.grad(total.sum(), th)
        out.append((delta[:, :24], total, g))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_wrapper_rejects_unknown_family():
    with pytest.raises(ValueError):
        tops.bright_glm(*_torch(*_inputs("logistic", 1, 8)), family="probit")


@pytest.mark.parametrize("family", ["logistic", "student_t", "softmax"])
def test_no_grad_fast_path_equals_autograd_path(family, monkeypatch):
    """Without a gradient to take, the wrapper calls the forward directly;
    what it returns is exactly what the ``autograd.Function`` returns."""
    *ops, theta = _torch(*_inputs(family, 2, 24, seed=3))
    th = theta.clone().requires_grad_(True)
    slow = tops.bright_glm(*ops, th, family=family, **KW[family])
    assert slow[1].grad_fn is not None

    def no_autograd(*args):
        raise AssertionError("the no-grad path went through autograd")

    monkeypatch.setattr(tops._BrightGLM, "apply", no_autograd)
    fast = tops.bright_glm(*ops, theta, family=family, **KW[family])
    with torch.no_grad():
        fast_ng = tops.bright_glm(*ops, th, family=family, **KW[family])
    for f in (fast, fast_ng):
        assert all(o.grad_fn is None for o in f)
        assert all(torch.equal(a, b.detach()) for a, b in zip(f, slow))


# Each bad operand, and what the refusal must name.
_FAULTS = {"x_dtype": "x", "x_rank": "x", "t_shape": "t", "t_dtype": "t",
           "xi_strided": "xi", "idx_stride": "idx", "idx_dtype": "idx",
           "n_bright_dtype": "n_bright", "n_bright_shape": "n_bright",
           "theta_shape": "theta", "theta_strided": "theta",
           "classes": "theta's", "shared_memory": "theta's", "empty": "empty"}


@pytest.mark.parametrize("fault", _FAULTS)
def test_kernel_path_refuses_bad_operands_before_launch(fault):
    """The card path's checks, run on CPU tensors (which pass its device
    checks), refuse each bad operand with a ValueError before the library is
    built or the arrival workspace is touched, naming the operand."""
    family = "softmax" if fault == "classes" else "logistic"
    x, t, xi, idx, nb, theta = _torch(*_inputs(family, 2, 24))
    if fault == "x_dtype":
        x = x.double()
    elif fault == "x_rank":
        x = x[None]
    elif fault == "t_shape":
        t = t[:-1]
    elif fault == "t_dtype":
        t = t.double()
    elif fault == "xi_strided":
        xi = torch.stack([xi, xi], 1)[:, 0]
    elif fault == "idx_stride":
        idx = idx.t().contiguous().t()
    elif fault == "idx_dtype":
        idx = idx.long()
    elif fault == "n_bright_dtype":
        nb = nb.int()
    elif fault == "n_bright_shape":
        nb = nb[:1]
    elif fault == "theta_shape":
        theta = theta[:, :-1].contiguous()
    elif fault == "theta_strided":
        theta = theta.t().contiguous().t()
    elif fault == "classes":  # a softmax of no class: neither kernel's
        xi = torch.zeros(N, 0)
        theta = torch.zeros(2, 0, D)
    elif fault == "shared_memory":  # Kt·D floats > 48 KiB, not a softmax
        x = torch.zeros(N, 12289)
        theta = torch.zeros(2, 12289)
    elif fault == "empty":
        idx, nb, theta = idx[:0], nb[:0], theta[:0]
    before = dict(tops._arrivals)
    with pytest.raises(ValueError, match=rf"^bright_glm: {_FAULTS[fault]} "):
        tops._launch(x, t, xi, idx, nb, theta, family, 4.0, 1.0)
    assert tops._arrivals == before


@pytest.mark.parametrize("family", ["logistic", "student_t", "softmax"])
@pytest.mark.parametrize("with_delta", [False, True])
def test_backward_equals_autograd_through_the_blocked_total_bitwise(
        family, with_delta):
    """The ``autograd.Function``'s backward hands the total's cotangent to
    each valid slot directly. Taking the slot cotangents by autograd through
    ``total_of_delta`` (its blocked sum) instead gives the same θ-gradient,
    bit for bit."""
    from repro_torch.core.numerics import tree_sum
    from repro_torch.kernels.bright_glm.ref import (
        delta_of_scores,
        row_scores,
        total_of_delta,
    )

    x, t, xi, idx, nb, theta = _torch(*_inputs(family, 3, 40, seed=5))
    g = torch.Generator().manual_seed(1)
    g_delta = torch.randn(idx.shape, generator=g)
    g_total = torch.randn(3, generator=g)
    th = theta.clone().requires_grad_(True)
    delta, total = tops.bright_glm(x, t, xi, idx, nb, th, family=family,
                                   **KW[family])
    outs, cots = ([delta, total], [g_delta, g_total]) if with_delta else (
        [total], [g_total])
    (got,) = torch.autograd.grad(outs, th, cots)

    i = idx.to(torch.int64).clamp(0, N - 1)
    rows = x[i]
    scores = row_scores(rows, theta, family).requires_grad_()
    d = delta_of_scores(scores, t[i], xi[i], family, **KW[family])
    r_outs = [d, total_of_delta(d, nb)] if with_delta else [
        total_of_delta(d, nb)]
    (g_scores,) = torch.autograd.grad(r_outs, scores, cots)
    prod = (g_scores[:, :, :, None] * rows[:, :, None, :]
            if family == "softmax" else g_scores[:, :, None] * rows)
    assert torch.equal(got, tree_sum(prod, dim=1))
