"""Plain PyTorch RG-LRU recurrence h_t = exp(log a_t)·h_{t-1} + b_t.

The counterpart of :func:`repro.kernels.rglru_scan.ref.rglru_ref`, the
function ``csrc/rglru_scan.cu`` computes: the sequential loop, one
multiply and one add per step, rounded as written; and its backward,
:func:`rglru_bwd_ref`, the function of the backward kernel. The CPU path and
the tests use them; on the card they are only the kernels' yardsticks of
correctness.
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


def rglru_bwd_ref(log_a, h, h0, g_h, g_last=None):
    """The backward of :func:`rglru_ref` for cotangents ``g_h`` (B, S, C) on
    every h_t and ``g_last`` (B, C) on h_final (None: zeros), given the
    forward's ``log_a``, its output ``h`` and ``h0`` (None: zeros).

    ``G_t = ∂L/∂h_t`` through every later step is the same recurrence run
    backwards in time: the scan of the time-flipped ``g_h`` from
    ``g_last`` with decays ``flip(log_a[:, 1:] ++ 0)``, so ``G_{S-1} =
    1·g_last + ḡ_{S-1}`` and ``G_t = a_{t+1}·G_{t+1} + ḡ_t``. Then
    ``∂b_t = G_t``, ``∂log_a_t = (G_t·a_t)·h_{t-1}`` with ``h_{-1} = h0``,
    and ``∂h0 = a_0·G_0``. Returns (∂log_a, ∂b, ∂h0), float32.
    """
    # decays of the reversed recurrence: a_{t+1} at step t, 1 at S-1
    la_next = torch.cat([log_a[:, 1:], torch.zeros_like(log_a[:, :1])], 1)
    g_rev, _ = rglru_ref(la_next.flip(1), g_h.flip(1), g_last)
    big_g = g_rev.flip(1)
    a = torch.exp(log_a)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]) if h0 is None
                        else h0[:, None], h[:, :-1]], 1)
    return big_g * a * h_prev, big_g, a[:, 0] * big_g[:, 0]
