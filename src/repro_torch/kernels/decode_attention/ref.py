"""Plain PyTorch flash-decode over a (possibly partial) ring cache.

The counterpart of :func:`repro.kernels.decode_attention.ref.
decode_attention_ref`: the function ``csrc/decode_attention.cu`` computes.
The CPU path and the tests use it; on the card it is only the kernel's
yardstick of correctness.
"""

from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k, v, pos, t: int, window: int | None = None):
    """q: (B, H, D); k/v: (B, W, Hk, D) f32 or bf16; pos: (W,) absolute
    positions (-1 = empty); t: position of the query token.

    Slot c takes part iff pos[c] >= 0, pos[c] <= t and (with a window)
    pos[c] > t - window; masked scores are -1e30, so a fully masked row has
    m = -1e30 and weights 1. Returns (out (B, H, D), m (B, Hk, G),
    l (B, Hk, G)), all float32 — the local softmax statistics that a
    cross-shard merge needs.
    """
    b, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    qf = q.float().reshape(b, hk, g, d) / math.sqrt(d)
    s = torch.einsum("bhgd,bchd->bhgc", qf, k.float())
    valid = (pos >= 0) & (pos <= t)
    if window is not None:
        valid = valid & (pos > t - window)
    s = torch.where(valid, s, -1e30)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhgc,bchd->bhgd", p, v.float())
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, d), m, l
