"""Wrapper for the bright-GLM kernel: checks, launch, launch count, gradient.

``bright_glm`` is the kernel engine's entry point, used by
:func:`repro_torch.core.flymc.make_joint_logpost` for the θ-update and by
:func:`repro_torch.core.flymc._candidate_delta` for the z-update's
candidates. A CUDA tensor goes to ``csrc/bright_glm.cu`` (or the wrapper
raises); a CPU tensor goes to the plain version in :mod:`.ref`. Chains are
the leading axis of ``idx``, ``n_bright`` and ``theta``; ``x``, ``t`` and
``xi`` are shared by every chain and never broadcast. A stack of L datasets
with a leading lane axis (the sampling service's ``"vmap"`` lanes) goes
with ``(L, K, ...)`` chain operands: one launch for every lane. A launch
goes to one of two kernels of the same source: the register kernel where
θ_k's classes × D fit it (at most 16 classes, 48 KiB), the wide kernel for
a softmax past that (an LM head's vocabulary), which streams θ_k; the
wrapper raises, naming the operand, for what neither takes.

The gradient (MALA, HMC) is a ``torch.autograd.Function`` whose forward is the
kernel and whose backward re-evaluates the rows with the plain version, as
the reference's ``custom_vjp`` does; it is taken with respect to θ only.
The row cotangents are summed into θ with ``tree_sum`` over the slot axis
(past the register kernel, by blocked matmuls summed in block order), so
padded slots (exact zeros) leave the gradient bitwise unchanged.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.numerics import log_expm1, tree_sum
from repro_torch.kernels import _build
from repro_torch.kernels.bright_glm.ref import (
    BLOCK_ROWS,
    FAMILIES,
    MAX_CLASSES,
    SMEM_BYTES,
    bright_glm_ref,
    delta_of_scores,
    flat_chains,
    register_path,
    row_scores,
    wide_theta_grad,
)

_FAMILY_CODE = {"logistic": 0, "student_t": 1, "softmax": 2}
_MAX_CHAINS = 65535  # the launch's grid y (z on the wide path): a chain each
# The wide softmax kernel (bright_glm_wide_kernel): rows a CTA, classes a
# split (a CTA), statistics a row, and its grid's limit on splits.
WIDE_ROWS, WIDE_SPLIT, _WIDE_STATS, _MAX_SPLITS = 64, 2048, 10, 65535

launch_count = 0  # kernel launches through this wrapper (one per call)
wide_launch_count = 0  # of which the wide softmax kernel's
# Per-chain arrival counters of the kernel's in-launch total, one int32
# workspace per (device, stream), zeroed once and left zeroed by every call
# (csrc/bright_glm.cu). Calls on one stream run in order and share it. The
# wide kernel also counts each (chain, row tile)'s splits in
# ``_tile_arrivals``, kept the same way.
_arrivals: dict[tuple[int, int], torch.Tensor] = {}
_tile_arrivals: dict[tuple[int, int], torch.Tensor] = {}


def _takes(kt: int, d: int, softmax: bool) -> bool:
    """Whether one of the two kernels takes θ's ``kt`` classes × D."""
    if kt < 1:
        return False
    if register_path(kt, d):
        return True
    return softmax and -(-kt // WIDE_SPLIT) <= _MAX_SPLITS


def _workspace(store, key, n, device):
    """The zeroed int32 counters of ``store[key]``, grown to ``n``."""
    ws = store.get(key)
    if ws is None or ws.numel() < n:
        ws = torch.zeros(n, dtype=torch.int32, device=device)
        store[key] = ws
    return ws


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"bright_glm: {msg}")


def _shapes(x, idx, theta, softmax):
    """The launch's shapes: (lane shape () or (L,), N, D, chain shape (K,)
    or (L, K), C, classes), or None where the ranks do not fit."""
    lanes = idx.dim() == 3
    if not (idx.dim() in (2, 3) and x.dim() == 2 + lanes
            and theta.dim() == idx.dim() - 1 + (2 if softmax else 1)):
        return None
    kt = theta.shape[-2] if softmax else 1
    return (tuple(x.shape[:-2]), *x.shape[-2:], tuple(idx.shape[:-1]),
            idx.shape[-1], kt)


def _refuse(x, t, xi, idx, n_bright, theta, softmax):
    """The launch's checks one at a time, once their combined test failed:
    raises naming the first operand the kernel cannot read."""
    dev = x.device
    for name, a in (("t", t), ("xi", xi), ("idx", idx), ("n_bright", n_bright),
                    ("theta", theta)):
        _require(a.device == dev, f"{name} is on {a.device}, x on {dev}")
    shapes = _shapes(x, idx, theta, softmax)
    _require(shapes is not None,
             "x must be (N, D) with idx (K, C) and theta "
             f"{'(K, Kc, D)' if softmax else '(K, D)'}, or a lane stack "
             "(L, N, D) with idx (L, K, C) and theta "
             f"{'(L, K, Kc, D)' if softmax else '(L, K, D)'}")
    ls, n, d, lead, c, kt = shapes
    _require(x.dtype == torch.float32 and x.is_contiguous(),
             f"x must be contiguous {ls + (n, d)} float32")
    _require(ls == lead[:-1], f"x holds lanes {ls}, idx {lead[:-1]}")
    _require(idx.dtype == torch.int32 and idx.stride(-1) == 1,
             "idx must be int32 with unit slot stride")
    want_t = torch.int64 if softmax else torch.float32
    _require(t.dtype == want_t and t.shape == ls + (n,) and t.is_contiguous(),
             f"t must be contiguous {ls + (n,)} {want_t}")
    xi_shape = ls + ((n, kt) if softmax else (n,))
    _require(xi.dtype == torch.float32 and xi.shape == xi_shape
             and xi.is_contiguous(), f"xi must be contiguous {xi_shape} float32")
    _require(n_bright.dtype == torch.int64 and n_bright.shape == lead
             and n_bright.is_contiguous(), f"n_bright must be {lead} int64")
    th_shape = lead + ((kt, d) if softmax else (d,))
    _require(theta.dtype == torch.float32 and theta.shape == th_shape
             and theta.is_contiguous(), f"theta must be contiguous {th_shape} f32")
    _require(_takes(kt, d, softmax),
             f"theta's {kt} classes × D={d}: the register kernel takes 1 to "
             f"{MAX_CLASSES} classes within {SMEM_BYTES} bytes, the wide "
             f"(softmax) kernel 1 to {_MAX_SPLITS * WIDE_SPLIT} classes")
    _require(c > 0 and min(lead) > 0 and n > 0,
             f"empty buffer (chains {lead}, C={c}, N={n})")
    _require(math.prod(lead) <= _MAX_CHAINS,
             f"{math.prod(lead)} chains exceed the launch's {_MAX_CHAINS}")
    raise ValueError("bright_glm: operands refused: " + _build.describe(
        x=x, t=t, xi=xi, idx=idx, n_bright=n_bright, theta=theta))


def _launch(x, t, xi, idx, n_bright, theta, family, nu, sigma):
    global launch_count, wide_launch_count
    # What the kernel reads, as one expression: device, dtype, shape,
    # stride and shared-memory size. Only if it fails does _refuse run the
    # checks one by one to name the operand.
    di = x.get_device()
    softmax = family == "softmax"
    shapes = _shapes(x, idx, theta, softmax)
    ok = shapes is not None
    if ok:
        ls, n, d, lead, c, kt = shapes
        ok = (t.get_device() == di and xi.get_device() == di
              and idx.get_device() == di and n_bright.get_device() == di
              and theta.get_device() == di and ls == lead[:-1]
              and x.dtype == torch.float32 and x.is_contiguous()
              and t.dtype == (torch.int64 if softmax else torch.float32)
              and t.shape == ls + (n,) and t.is_contiguous()
              and xi.dtype == torch.float32 and xi.is_contiguous()
              and xi.shape == ls + ((n, kt) if softmax else (n,))
              and idx.dtype == torch.int32 and idx.stride(-1) == 1
              and n_bright.dtype == torch.int64 and n_bright.shape == lead
              and n_bright.is_contiguous()
              and theta.dtype == torch.float32 and theta.is_contiguous()
              and theta.shape == lead + ((kt, d) if softmax else (d,))
              and _takes(kt, d, softmax)
              and c > 0 and min(lead) > 0 and n > 0
              and math.prod(lead) <= _MAX_CHAINS)
    if not ok:
        _refuse(x, t, xi, idx, n_bright, theta, softmax)
    # One lane (a shared dataset) or L lanes of K chains. The lane strides
    # of the contiguous stacks; unused for one lane.
    lanes = len(lead) == 2
    L, k = lead if lanes else (1, lead[0])
    x_lane, t_lane, xi_lane = ((x.stride(0), t.stride(0), xi.stride(0))
                               if lanes else (0, 0, 0))
    idx_lane = idx.stride(0) if lanes else 0
    lk = L * k
    wide = not register_path(kt, d)
    lib = _build.library()
    stream = _build.stream_ptr(x.device)
    arrivals = _workspace(_arrivals, (di, stream), lk, x.device)
    # One allocation: δ (L·K, C), the totals (L·K,), the block partials,
    # then (wide kernel) the splits' statistics.
    nblk = -(-c // BLOCK_ROWS)
    tiles = -(-c // WIDE_ROWS)
    n_stats = (lk * tiles * -(-kt // WIDE_SPLIT) * _WIDE_STATS * WIDE_ROWS
               if wide else 0)
    buf = torch.empty(lk * (c + 1 + nblk) + n_stats, dtype=torch.float32,
                      device=x.device)
    delta = buf.as_strided(lead + (c,), (k * c, c, 1)[-len(lead) - 1:])
    total = buf.as_strided(lead, (k, 1)[-len(lead):], lk * c)
    ptr = buf.data_ptr()
    head = (x.data_ptr(), t.data_ptr(), xi.data_ptr(), idx.data_ptr(),
            idx.stride(-2), n_bright.data_ptr(), theta.data_ptr(), ptr,
            ptr + 4 * lk * (c + 1), ptr + 4 * lk * c)
    lanes_args = (L, x_lane, t_lane, xi_lane, idx_lane, stream)
    if wide:
        tile_arrivals = _workspace(_tile_arrivals, (di, stream), lk * tiles,
                                   x.device)
        code = lib.bright_glm_wide_launch(
            *head, ptr + 4 * lk * (c + 1 + nblk), arrivals.data_ptr(),
            tile_arrivals.data_ptr(), k, c, n, d, kt, *lanes_args)
        wide_launch_count += 1
    else:
        code = lib.bright_glm_launch(
            *head, arrivals.data_ptr(), k, c, n, d, kt, _FAMILY_CODE[family],
            nu, sigma, (nu + 1.0) / 2.0, *lanes_args)
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
        # Lanes, if any, flattened into one chain axis.
        rows, t_rows, xi_rows, n_bright, th = flat_chains(
            x, t, xi, idx, n_bright, theta)
        with torch.enable_grad():
            scores = row_scores(rows, th, family).detach().requires_grad_()
            delta = delta_of_scores(scores, t_rows, xi_rows, family, nu,
                                    sigma)
            outs, grads = [], []
            if g_delta is not None:
                outs.append(delta)
                grads.append(g_delta.reshape(delta.shape))
            if g_total is not None:
                # The total is Σ log_expm1(δ) over the first n_bright slots,
                # so its cotangent there is g_total and 0 past them: what
                # autograd through total_of_delta's blocked sum gives, with
                # none of its per-row nodes.
                slots = torch.arange(delta.shape[1], device=delta.device)
                valid = slots[None] < n_bright.to(torch.int64)[:, None]
                outs.append(log_expm1(delta))
                grads.append(torch.where(valid, g_total.reshape(-1, 1),
                                         torch.zeros_like(delta)))
            (g_scores,) = torch.autograd.grad(outs, (scores,), grads)
        if family != "softmax":  # (K, C) ⊗ (K, C, D) → (K, D)
            g_theta = tree_sum(g_scores[:, :, None] * rows, dim=1)
        elif register_path(g_scores.shape[-1], rows.shape[-1]):
            # (K, C, Kc) ⊗ (K, C, D) → (K, Kc, D)
            g_theta = tree_sum(g_scores[:, :, :, None] * rows[:, :, None, :],
                               dim=1)
        else:
            g_theta = wide_theta_grad(g_scores, rows)
        g_theta = g_theta.reshape(theta.shape)
        return g_theta, None, None, None, None, None, None, None, None


def bright_glm(x, t, xi, idx, n_bright, theta, family="logistic", nu=4.0,
               sigma=1.0):
    """Fused bright-buffer evaluation for K chains, or for L lanes of K
    chains.

    x (N, D) f32; t (N,) f32 labels/responses, or int64 class ids (softmax);
    xi (N,) f32, or (N, Kc) tangency logits (softmax); idx (K, C) int32 slot
    → datum ids (padding may be ≥ N; clamped); n_bright (K,) int64 — the
    first n_bright[k] slots of chain k are valid; theta (K, D) or (K, Kc, D).
    Returns (delta (K, C), total (K,)); differentiable in θ.

    Lanes: x (L, N, D), t (L, N), xi (L, N) or (L, N, Kc) stack L datasets,
    and the chain operands lead with (L, K): idx (L, K, C), n_bright (L, K),
    theta (L, K, D) or (L, K, Kc, D); chain (l, k) reads lane l's rows.
    Returns (delta (L, K, C), total (L, K)) in one launch, bitwise L
    single-lane calls.
    """
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; expected {FAMILIES}")
    nu, sigma = float(nu), float(sigma)
    if torch.is_grad_enabled() and theta.requires_grad:
        return _BrightGLM.apply(theta, x, t, xi, idx, n_bright, family, nu,
                                sigma)
    # No gradient is asked for (RWMH, or under no_grad): skip autograd.
    return _forward(x, t, xi, idx, n_bright, theta, family, nu, sigma)
