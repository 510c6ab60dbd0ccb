"""Wrapper for the RG-LRU scan kernel: checks, launch, launch count.

Entry point of :func:`repro_torch.models.layers.rglru_mix`, one call per
RG-LRU layer per prefill or training forward. A CUDA tensor goes to
``csrc/rglru_scan.cu`` (or the wrapper raises); a CPU tensor goes to the
plain version in :mod:`.ref`.

Both devices go through one autograd Function, :class:`RGLRUScan`. Its
backward is the same linear recurrence run backwards in time, so it is the
same kernel (or loop) once more: with ``G_t = ḡ_t + a_{t+1}·G_{t+1}`` from
``G_{S-1} = ḡ_{S-1} + ḡ_final``, ``G`` is the scan of the time-flipped ``ḡ``
from ``h0 = ḡ_final`` with decays ``flip(log_a[:, 1:] ++ 0)``; then
``∂b_t = G_t``, ``∂log_a_t = G_t·a_t·h_{t-1}`` and ``∂h0 = a_0·G_0``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_ref

launch_count = 0  # kernel launches: one per forward, one per backward


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rglru_scan: {msg}")


def _launch(log_a, bx, h0):
    global launch_count
    b, s, c = log_a.shape
    dev = log_a.device
    for name, a in (("log_a", log_a), ("bx", bx)):
        _require(a.device == dev and a.dtype == torch.float32
                 and a.shape == (b, s, c) and a.is_contiguous(),
                 f"{name} must be contiguous ({b}, {s}, {c}) float32 on {dev}")
    if h0 is not None:
        _require(h0.device == dev and h0.dtype == torch.float32
                 and h0.shape == (b, c) and h0.is_contiguous(),
                 f"h0 must be contiguous ({b}, {c}) float32 on {dev}")
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


def _scan(log_a, bx, h0):
    if log_a.is_cuda:
        return _launch(log_a, bx, h0)
    if log_a.device.type == "cpu":
        return rglru_ref(log_a, bx, h0)
    raise ValueError(f"rglru_scan: unsupported device {log_a.device}")


class RGLRUScan(torch.autograd.Function):
    """The scan with its reverse-time backward (one more scan)."""

    @staticmethod
    def forward(ctx, log_a, bx, h0):
        h, h_last = _scan(log_a, bx, h0)
        ctx.save_for_backward(log_a, h, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, g_h, g_last):
        log_a, h, h0 = ctx.saved_tensors
        # decays of the reversed recurrence: a_{t+1} at step t, 1 at S-1
        la_next = torch.cat([log_a[:, 1:], torch.zeros_like(log_a[:, :1])], 1)
        g_rev, _ = _scan(la_next.flip(1).contiguous(),
                         g_h.flip(1).contiguous(), g_last.contiguous())
        big_g = g_rev.flip(1)  # G_t = ∂L/∂h_t through every later step
        a = torch.exp(log_a)
        d_log_a = d_h0 = None
        if ctx.needs_input_grad[0]:
            h_prev = torch.cat([torch.zeros_like(h[:, :1]) if h0 is None
                                else h0[:, None], h[:, :-1]], 1)
            d_log_a = big_g * a * h_prev
        if ctx.needs_input_grad[2]:
            d_h0 = a[:, 0] * big_g[:, 0]
        d_bx = big_g if ctx.needs_input_grad[1] else None
        return d_log_a, d_bx, d_h0


def rglru_scan(log_a, bx, h0=None):
    """The RG-LRU recurrence h_t = exp(log_a_t)·h_{t-1} + b_t per channel.

    log_a, bx (B, S, C) float32 (log_a <= 0); h0 (B, C) float32 or None
    (zeros). Returns (h (B, S, C), h_final (B, C)) float32, differentiable
    in log_a, bx and h0.
    """
    return RGLRUScan.apply(log_a, bx, h0)
