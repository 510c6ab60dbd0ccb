"""Wrappers for the RG-LRU scan kernels: checks, launch, launch counts.

Entry point of :func:`repro_torch.models.layers.rglru_mix`, one call per
RG-LRU layer per prefill or training forward. A CUDA tensor goes to
``csrc/rglru_scan.cu`` (or the wrapper raises); a CPU tensor goes to the
plain versions in :mod:`.ref`.

Both devices go through one autograd Function, :class:`RGLRUScan`. Its
backward, :func:`rglru_scan_backward`, is one launch of
``rglru_scan_bwd_kernel`` on the card, which walks the recurrence backwards
in time and writes ∂log_a, ∂b and ∂h0 itself (no other tensor op), and
:func:`.ref.rglru_bwd_ref` on the CPU. The kernel chooses how it stages its
inputs from C and the operands' alignment (TMA for C % 4 == 0, cp.async
otherwise); it takes any positive shape whose B·⌈C/32⌉ fits a grid.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref, rglru_ref

launch_count = 0  # kernel launches: one per forward, one per backward
bwd_launch_count = 0  # of which backward kernel launches


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rglru_scan: {msg}")


def _check(dev, shape, **tensors) -> None:
    for name, a in tensors.items():
        if a is not None:
            _require(a.device == dev and a.dtype == torch.float32
                     and a.shape == shape and a.is_contiguous(),
                     f"{name} must be contiguous {tuple(shape)} float32 on "
                     f"{dev}")


def _launch(log_a, bx, h0):
    global launch_count
    b, s, c = log_a.shape
    dev = log_a.device
    _check(dev, (b, s, c), log_a=log_a, bx=bx)
    _check(dev, (b, c), h0=h0)
    _require(b > 0 and s > 0 and c > 0, "empty operand")
    lib = _build.library()
    y = torch.empty(b, s, c, dtype=torch.float32, device=dev)
    h_last = torch.empty(b, c, dtype=torch.float32, device=dev)
    code = lib.rglru_scan_launch(
        log_a.data_ptr(), bx.data_ptr(),
        None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), b, s, c, _build.stream_ptr(dev),
    )
    launch_count += 1
    _build.check(code, "rglru_scan")
    return y, h_last


def _launch_bwd(log_a, h, h0, g_h, g_last, needs):
    global launch_count, bwd_launch_count
    b, s, c = log_a.shape
    dev = log_a.device
    _check(dev, (b, s, c), log_a=log_a, h=h, g_h=g_h)
    _check(dev, (b, c), h0=h0, g_last=g_last)
    _require(b > 0 and s > 0 and c > 0, "empty operand")
    lib = _build.library()
    d_log_a = (torch.empty(b, s, c, dtype=torch.float32, device=dev)
               if needs[0] else None)
    d_bx = torch.empty(b, s, c, dtype=torch.float32, device=dev)
    d_h0 = (torch.empty(b, c, dtype=torch.float32, device=dev)
            if needs[2] and h0 is not None else None)
    ptr = lambda a: None if a is None else a.data_ptr()
    code = lib.rglru_scan_bwd_launch(
        log_a.data_ptr(), g_h.data_ptr(), h.data_ptr(), ptr(h0), ptr(g_last),
        ptr(d_log_a), d_bx.data_ptr(), ptr(d_h0), b, s, c,
        _build.stream_ptr(dev),
    )
    launch_count += 1
    bwd_launch_count += 1
    _build.check(code, "rglru_scan_bwd")
    return d_log_a, d_bx if needs[1] else None, d_h0


def _scan(log_a, bx, h0):
    if log_a.is_cuda:
        return _launch(log_a, bx, h0)
    if log_a.device.type == "cpu":
        return rglru_ref(log_a, bx, h0)
    raise ValueError(f"rglru_scan: unsupported device {log_a.device}")


def rglru_scan_backward(log_a, h, h0, g_h, g_last=None,
                        needs=(True, True, True)):
    """The backward of :func:`rglru_scan`: ``g_h`` (B, S, C) and ``g_last``
    (B, C) or None (zeros) are the cotangents of h and h_final, ``h`` the
    forward's output. Returns (∂log_a, ∂b, ∂h0), each None where ``needs``
    (as ``ctx.needs_input_grad``) says it is not wanted; ∂h0 is None when
    ``h0`` is."""
    if log_a.is_cuda:
        return _launch_bwd(log_a, h, h0, g_h, g_last, needs)
    if log_a.device.type == "cpu":
        grads = rglru_bwd_ref(log_a, h, h0, g_h, g_last)
        return tuple(g if want else None for g, want in
                     zip(grads, (needs[0], needs[1],
                                 needs[2] and h0 is not None)))
    raise ValueError(f"rglru_scan: unsupported device {log_a.device}")


class RGLRUScan(torch.autograd.Function):
    """The scan with its reverse-time backward."""

    @staticmethod
    def forward(ctx, log_a, bx, h0):
        h, h_last = _scan(log_a, bx, h0)
        ctx.save_for_backward(log_a, h, h0)
        # an unused h_final's cotangent arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        return h, h_last

    @staticmethod
    def backward(ctx, g_h, g_last):
        log_a, h, h0 = ctx.saved_tensors
        g_h = torch.zeros_like(h) if g_h is None else g_h.contiguous()
        if g_last is not None:
            g_last = g_last.contiguous()
        return rglru_scan_backward(log_a, h, h0, g_h, g_last,
                                   ctx.needs_input_grad)


def rglru_scan(log_a, bx, h0=None):
    """The RG-LRU recurrence h_t = exp(log_a_t)·h_{t-1} + b_t per channel.

    log_a, bx (B, S, C) float32 (log_a <= 0); h0 (B, C) float32 or None
    (zeros). Returns (h (B, S, C), h_final (B, C)) float32, differentiable
    in log_a, bx and h0.
    """
    return RGLRUScan.apply(log_a, bx, h0)
