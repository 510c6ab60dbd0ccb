"""Plain PyTorch flash-decode over a (possibly partial) ring cache.

The counterpart of :func:`repro.kernels.decode_attention.ref.
decode_attention_ref`: the function ``csrc/decode_attention.cu`` computes,
whole (``decode_attention_ref``) and as the kernel splits it (per-split
partials, then a merge in split order). The CPU path and the tests use it;
on the card it is only the kernel's yardstick of correctness.
"""

from __future__ import annotations

import math

import torch


def _parts(q, k, v, pos, t: int, window: int | None):
    """(m, l, acc) of the slots in k/v: the row max of the masked scores,
    Σ e^{s - m} and the unnormalised Σ e^{s - m}·v, float32."""
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
    return m, p.sum(-1), torch.einsum("bhgc,bchd->bhgd", p, v.float())


def decode_attention_ref(q, k, v, pos, t: int, window: int | None = None):
    """q: (B, H, D); k/v: (B, W, Hk, D) f32 or bf16; pos: (W,) absolute
    positions (-1 = empty); t: position of the query token.

    Slot c takes part iff pos[c] >= 0, pos[c] <= t and (with a window)
    pos[c] > t - window; masked scores are -1e30, so a fully masked row has
    m = -1e30 and weights 1. Returns (out (B, H, D), m (B, Hk, G),
    l (B, Hk, G)), all float32 — the local softmax statistics that a
    cross-shard merge needs.
    """
    m, l, o = _parts(q, k, v, pos, t, window)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(q.shape), m, l


def split_partials_ref(q, k, v, pos, t: int, window: int | None,
                       split_len: int):
    """What the kernel's first launch computes: the ring cut into splits of
    ``split_len`` slots (the last may be shorter), and for split j its
    (m_j, l_j, acc_j) with acc_j unnormalised. A fully masked split has
    m_j = -1e30 and l_j = its number of slots. Returns (m (n_split, B, Hk,
    G), l (n_split, B, Hk, G), acc (n_split, B, Hk, G, D)) float32."""
    w = k.shape[1]
    parts = [_parts(q, k[:, s0:s0 + split_len], v[:, s0:s0 + split_len],
                    pos[s0:s0 + split_len], t, window)
             for s0 in range(0, w, split_len)]
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    return m, l, acc


def split_merge_ref(m_j, l_j, acc_j):
    """What the kernel's second launch computes: the splits merged in split
    order, m = max_j m_j, l = Σ_j l_j·e^{m_j - m}, acc likewise, out =
    acc / max(l, 1e-30). m_j, l_j (n_split, B, Hk, G), acc_j (n_split, B,
    Hk, G, D). Returns (out (B, Hk·G, D), m (B, Hk, G), l (B, Hk, G))."""
    m = m_j.amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(acc_j[0])
    for mj, lj, aj in zip(m_j, l_j, acc_j):
        wj = torch.exp(mj - m)
        l = l + lj * wj
        acc = acc + aj * wj[..., None]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    b, hk, g, d = out.shape
    return out.reshape(b, hk * g, d), m, l
