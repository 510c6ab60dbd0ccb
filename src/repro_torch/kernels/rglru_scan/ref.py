"""Plain PyTorch RG-LRU recurrence h_t = exp(log a_t)·h_{t-1} + b_t.

The counterpart of :func:`repro.kernels.rglru_scan.ref.rglru_ref`, the
function ``csrc/rglru_scan.cu`` computes: the sequential loop, one
multiply and one add per step, rounded as written. The CPU path and the
tests use it; on the card it is only the kernel's yardstick of correctness.
"""

from __future__ import annotations

import torch


def rglru_ref(log_a, bx, h0=None):
    """log_a, bx: (B, S, C); h0: (B, C) or None (zeros). Returns
    (h (B, S, C), h_final (B, C)), float32."""
    b, s, c = log_a.shape
    a = torch.exp(log_a.float())
    bv = bx.float()
    h = (torch.zeros(b, c, dtype=torch.float32, device=log_a.device)
         if h0 is None else h0.float())
    ys = torch.empty(b, s, c, dtype=torch.float32, device=log_a.device)
    for i in range(s):
        h = a[:, i] * h + bv[:, i]
        ys[:, i] = h
    return ys, h
