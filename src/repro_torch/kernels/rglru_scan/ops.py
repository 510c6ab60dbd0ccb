"""Wrapper for the RG-LRU scan kernel: checks, launch, launch count.

Entry point of :func:`repro_torch.models.layers.rglru_mix`, one call per
RG-LRU layer per prefill. A CUDA tensor goes to ``csrc/rglru_scan.cu`` (or
the wrapper raises); a CPU tensor goes to the plain version in :mod:`.ref`.
No gradient: serving only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_ref

launch_count = 0  # kernel launches through this wrapper (one per call)


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


def rglru_scan(log_a, bx, h0=None):
    """The RG-LRU recurrence h_t = exp(log_a_t)·h_{t-1} + b_t per channel.

    log_a, bx (B, S, C) float32 (log_a <= 0); h0 (B, C) float32 or None
    (zeros). Returns (h (B, S, C), h_final (B, C)) float32.
    """
    if log_a.is_cuda:
        return _launch(log_a, bx, h0)
    if log_a.device.type == "cpu":
        return rglru_ref(log_a, bx, h0)
    raise ValueError(f"rglru_scan: unsupported device {log_a.device}")
