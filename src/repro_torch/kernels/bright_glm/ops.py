"""Wrapper for the bright-GLM kernel: checks, launch, launch count, gradient.

``bright_glm`` is the kernel engine's entry point, used by
:func:`repro_torch.core.flymc.make_joint_logpost` for the θ-update and by
:func:`repro_torch.core.flymc._candidate_delta` for the z-update's
candidates. A CUDA tensor goes to ``csrc/bright_glm.cu`` (or the wrapper
raises); a CPU tensor goes to the plain version in :mod:`.ref`. Chains are
the leading axis of ``idx``, ``n_bright`` and ``theta``; ``x``, ``t`` and
``xi`` are shared by every chain and never broadcast.

The gradient (MALA) is a ``torch.autograd.Function`` whose forward is the
kernel and whose backward re-evaluates the rows with the plain version, as
the reference's ``custom_vjp`` does; it is taken with respect to θ only.
The row cotangents are summed into θ with ``tree_sum`` over the slot axis,
so padded slots (exact zeros) leave the gradient bitwise unchanged.
"""

from __future__ import annotations

import torch

from repro_torch.core.numerics import tree_sum
from repro_torch.kernels import _build
from repro_torch.kernels.bright_glm.ref import (
    BLOCK_ROWS,
    FAMILIES,
    bright_glm_ref,
    delta_of_scores,
    row_scores,
    total_of_delta,
)

_FAMILY_CODE = {"logistic": 0, "student_t": 1, "softmax": 2}
_MAX_CLASSES = 16  # kMaxClasses in csrc/bright_glm.cu

launch_count = 0  # kernel launches through this wrapper (one per call)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"bright_glm: {msg}")


def _launch(x, t, xi, idx, n_bright, theta, family, nu, sigma):
    global launch_count
    k, c = idx.shape
    n, d = x.shape
    kt = theta.shape[1] if family == "softmax" else 1
    dev = x.device
    for name, a in (("t", t), ("xi", xi), ("idx", idx), ("n_bright", n_bright),
                    ("theta", theta)):
        _require(a.device == dev, f"{name} is on {a.device}, x on {dev}")
    _require(x.dtype == torch.float32 and x.is_contiguous(),
             "x must be contiguous float32")
    want_t = torch.int64 if family == "softmax" else torch.float32
    _require(t.dtype == want_t and t.shape == (n,) and t.is_contiguous(),
             f"t must be contiguous ({n},) {want_t}")
    xi_shape = (n, kt) if family == "softmax" else (n,)
    _require(xi.dtype == torch.float32 and xi.shape == xi_shape
             and xi.is_contiguous(), f"xi must be contiguous {xi_shape} float32")
    _require(idx.dtype == torch.int32 and idx.dim() == 2 and idx.stride(1) == 1,
             "idx must be (K, C) int32 with unit slot stride")
    _require(n_bright.dtype == torch.int64 and n_bright.shape == (k,)
             and n_bright.is_contiguous(), f"n_bright must be ({k},) int64")
    th_shape = (k, kt, d) if family == "softmax" else (k, d)
    _require(theta.dtype == torch.float32 and theta.shape == th_shape
             and theta.is_contiguous(), f"theta must be contiguous {th_shape} f32")
    _require(kt <= _MAX_CLASSES and kt * d * 4 <= 48 * 1024,
             f"{kt} classes × D={d} exceed the kernel's shared memory")
    _require(0 < c and 0 < k and 0 < n, "empty buffer")
    lib = _build.library()
    delta = torch.empty(k, c, dtype=torch.float32, device=dev)
    partials = torch.empty(k, -(-c // BLOCK_ROWS), dtype=torch.float32,
                           device=dev)
    total = torch.empty(k, dtype=torch.float32, device=dev)
    code = lib.bright_glm_launch(
        x.data_ptr(), t.data_ptr(), xi.data_ptr(), idx.data_ptr(),
        idx.stride(0), n_bright.data_ptr(), theta.data_ptr(),
        delta.data_ptr(), partials.data_ptr(), total.data_ptr(),
        k, c, n, d, kt, _FAMILY_CODE[family], float(nu), float(sigma),
        (float(nu) + 1.0) / 2.0, _build.stream_ptr(dev),
    )
    launch_count += 1
    _build.check(code, "bright_glm")
    return delta, total


def _forward(x, t, xi, idx, n_bright, theta, family, nu, sigma):
    if x.is_cuda:
        return _launch(x, t, xi, idx, n_bright, theta, family, nu, sigma)
    if x.device.type == "cpu":
        return bright_glm_ref(x, t, xi, idx, n_bright, theta, family, nu, sigma)
    raise ValueError(f"bright_glm: unsupported device {x.device}")


class _BrightGLM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, x, t, xi, idx, n_bright, family, nu, sigma):
        ctx.save_for_backward(theta, x, t, xi, idx, n_bright)
        ctx.cfg = (family, nu, sigma)
        return _forward(x, t, xi, idx, n_bright, theta, family, nu, sigma)

    @staticmethod
    def backward(ctx, g_delta, g_total):
        theta, x, t, xi, idx, n_bright = ctx.saved_tensors
        family, nu, sigma = ctx.cfg
        i = idx.to(torch.int64).clamp(0, x.shape[0] - 1)
        rows = x[i]
        with torch.enable_grad():
            scores = row_scores(rows, theta, family).detach().requires_grad_()
            delta = delta_of_scores(scores, t[i], xi[i], family, nu, sigma)
            total = total_of_delta(delta, n_bright)
            outs, grads = [], []
            if g_delta is not None:
                outs.append(delta)
                grads.append(g_delta)
            if g_total is not None:
                outs.append(total)
                grads.append(g_total)
            (g_scores,) = torch.autograd.grad(outs, (scores,), grads)
        if family == "softmax":  # (K, C, Kc) ⊗ (K, C, D) → (K, Kc, D)
            prod = g_scores[:, :, :, None] * rows[:, :, None, :]
        else:  # (K, C) ⊗ (K, C, D) → (K, D)
            prod = g_scores[:, :, None] * rows
        g_theta = tree_sum(prod, dim=1)
        return g_theta, None, None, None, None, None, None, None, None


def bright_glm(x, t, xi, idx, n_bright, theta, family="logistic", nu=4.0,
               sigma=1.0):
    """Fused bright-buffer evaluation for K chains.

    x (N, D) f32; t (N,) f32 labels/responses, or int64 class ids (softmax);
    xi (N,) f32, or (N, Kc) tangency logits (softmax); idx (K, C) int32 slot
    → datum ids (padding may be ≥ N; clamped); n_bright (K,) int64 — the
    first n_bright[k] slots of chain k are valid; theta (K, D) or (K, Kc, D).
    Returns (delta (K, C), total (K,)); differentiable in θ.
    """
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; expected {FAMILIES}")
    return _BrightGLM.apply(theta, x, t, xi, idx, n_bright, family,
                            float(nu), float(sigma))
