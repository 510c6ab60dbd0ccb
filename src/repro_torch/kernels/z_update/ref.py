"""Plain PyTorch version of the z-candidate kernel (``csrc/z_update.cu``).

Evaluates the same counter-based Threefry draws as the kernel over each
chain's whole partition array at once and compacts with a cumsum scatter —
the O(N)-materializing formulation the kernel replaces. The kernel's output
must equal it bitwise.
"""

from __future__ import annotations

import torch

from repro_torch.core.brightness import scatter_drop
from repro_torch.core.numerics import DRAW_CAND, counter_bits24


def q_threshold_bits(q_db: float) -> int:
    """Static 24-bit integer threshold: bits24 < q_bits ⇔ u < q_db.

    Any positive ``q_db`` maps to at least 1; only ``q_db == 0`` disables
    proposals (see the reference for why rounding to zero is wrong).
    """
    q = float(q_db)
    if q <= 0.0:
        return 0
    return min(1 << 24, max(1, int(round(q * (1 << 24)))))


def z_candidates_ref(arr, num, key_words, q_db: float, cand_capacity: int):
    """arr (K, N) int32, num (K,), key_words (K, 2) → (cand (K, cap) int32
    padded with N, n_cand (K,) int32). With lanes, ``(L, K)`` leads every
    operand and output in place of ``(K,)``; each chain is drawn on its own,
    so the result is L single-lane calls'."""
    if arr.dim() == 3:
        lanes = tuple(arr.shape[:2])
        cand, n_cand = z_candidates_ref(
            arr.reshape(-1, arr.shape[-1]), num.reshape(-1),
            key_words.reshape(-1, 2), q_db, cand_capacity)
        return cand.reshape(lanes + (-1,)), n_cand.reshape(lanes)
    k, n = arr.shape
    pos = torch.arange(n, device=arr.device)[None]
    bits24 = counter_bits24(key_words, DRAW_CAND, arr)
    cand = (pos >= num.to(torch.int64)[:, None]) & (bits24 < q_threshold_bits(q_db))
    n_cand = cand.sum(dim=1).to(torch.int32)
    dest = torch.where(cand, torch.cumsum(cand, dim=1) - 1, cand_capacity)
    out = torch.full((k, cand_capacity), n, dtype=torch.int32, device=arr.device)
    return scatter_drop(out, dest, arr), n_cand
