"""Bright/dark set (paper §3.3, Fig. 3), chain-batched.

Port of :mod:`repro.core.brightness`. Every tensor carries a leading chain
axis:

  arr : (K, N) int32 permutations with all *bright* indices first
  tab : (K, N) int32 inverse permutations (tab[k, n] = position of n in arr[k])
  num : (K,)   int64 bright counts

torch has no ``mode="drop"`` scatter, so every scatter that may carry the
sentinel index ``N`` (or another out-of-range slot) goes into a buffer one
slot longer whose last slot is dead, and is sliced afterwards. Valid scatter
indices are always distinct: CUDA scatters with duplicate indices are not
deterministic, and only the dead slot ever sees duplicates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class BrightState(NamedTuple):
    arr: torch.Tensor  # (K, N) int32 permutation, bright indices first
    tab: torch.Tensor  # (K, N) int32 inverse permutation
    num: torch.Tensor  # (K,) int64 bright count


def scatter_drop(base: torch.Tensor, index: torch.Tensor, src) -> torch.Tensor:
    """``base.at[index].set(src, mode="drop")`` along dim 1: indices outside
    ``[0, base.shape[1])`` land in a dead extra slot that is sliced off."""
    k, n = base.shape
    buf = torch.cat([base, base.new_zeros(k, 1)], dim=1)
    index = index.to(torch.int64)
    index = torch.where((index >= 0) & (index < n), index, n)
    if not torch.is_tensor(src):
        src = torch.full(index.shape, src, dtype=base.dtype, device=base.device)
    return buf.scatter(1, index, src.to(base.dtype))[:, :n]


def init(n: int, num_chains: int = 1, bright: bool = False,
         device="cuda") -> BrightState:
    """All-dark (default) or all-bright partitions for ``num_chains`` chains."""
    dev = resolve_device(device)
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(num_chains, n)
    num = torch.full((num_chains,), n if bright else 0, dtype=torch.int64,
                     device=dev)
    return BrightState(arr=idx.clone(), tab=idx.clone(), num=num)


def from_z(z: torch.Tensor) -> BrightState:
    """Build the partitions from a (K, N) boolean brightness mask (stable)."""
    z = z.to(torch.bool)
    k, n = z.shape
    num = z.sum(dim=1)
    pos_b = torch.cumsum(z, dim=1) - 1
    pos_d = num[:, None] + torch.cumsum(~z, dim=1) - 1
    tab = torch.where(z, pos_b, pos_d)
    ids = torch.arange(n, dtype=torch.int32, device=z.device).expand(k, n)
    arr = torch.zeros(k, n, dtype=torch.int32, device=z.device).scatter(1, tab, ids)
    return BrightState(arr=arr, tab=tab.to(torch.int32), num=num)


def z_of(state: BrightState) -> torch.Tensor:
    """(K, N) boolean brightness: z[k, n] = (position of n) < num[k]."""
    return state.tab < state.num[:, None]


def _swap(state: BrightState, datum, pos, boundary, other, move,
          num) -> BrightState:
    """Per chain where ``move``: ``datum`` (at ``pos``) and ``other`` (at
    ``boundary``) trade places, and the count becomes ``num``."""
    n = state.arr.shape[1]
    b = boundary.clamp(0, n - 1)
    arr = state.arr.scatter(1, b, datum.to(torch.int32))
    arr = arr.scatter(1, pos, other.to(torch.int32))
    tab = state.tab.scatter(1, datum, b.to(torch.int32))
    tab = tab.scatter(1, other, pos.to(torch.int32))
    keep = move[:, None]
    return BrightState(arr=torch.where(keep, arr, state.arr),
                       tab=torch.where(keep, tab, state.tab),
                       num=torch.where(move, num, state.num))


def brighten(state: BrightState, datum: torch.Tensor) -> BrightState:
    """The paper's O(1) swap: z[k, datum[k]] = 1 (no-op where already
    bright). ``datum`` is (K,)."""
    n = state.arr.shape[1]
    d = datum.to(torch.int64)[:, None]
    pos = state.tab.gather(1, d).to(torch.int64)
    boundary = state.num[:, None]  # first dark slot
    other = state.arr.gather(1, boundary.clamp(max=n - 1)).to(torch.int64)
    move = (pos >= boundary)[:, 0]
    return _swap(state, d, pos, boundary, other, move, state.num + 1)


def darken(state: BrightState, datum: torch.Tensor) -> BrightState:
    """The paper's O(1) swap: z[k, datum[k]] = 0 (no-op where already dark).
    ``datum`` is (K,)."""
    d = datum.to(torch.int64)[:, None]
    pos = state.tab.gather(1, d).to(torch.int64)
    boundary = state.num[:, None] - 1  # last bright slot
    other = state.arr.gather(1, boundary.clamp(min=0)).to(torch.int64)
    move = (pos <= boundary)[:, 0]
    return _swap(state, d, pos, boundary, other, move, state.num - 1)


def batch_update(state: BrightState, z_new: torch.Tensor) -> BrightState:
    """Replace the whole partition given a new (K, N) boolean z."""
    del state
    return from_z(z_new)


def apply_flips(
    state: BrightState,
    darken: torch.Tensor,  # (K, C) bool over bright-buffer slots
    brighten_idx: torch.Tensor,  # (K, S) datum ids (masked entries may be N)
    brighten_mask: torch.Tensor,  # (K, S) bool
) -> BrightState:
    """Batched O(changed) partition update — the paper's Fig.-3 swaps
    vectorized over one z-round (see the reference for the pairing argument).

    Items that must enter the new bright region ``[0, num')`` are paired in
    buffer-slot order with items that must leave it, and each pair swaps.
    Slot order is ``arr``-position order, so the result is bitwise
    independent of the buffer capacities.
    """
    arr, tab, num = state
    k, n = arr.shape
    sd = darken.shape[1]
    sb = brighten_idx.shape[1]
    dev = arr.device
    slots = torch.arange(sd, dtype=torch.int64, device=dev)[None]  # (1, sd)
    numc = num[:, None]
    darken = darken & (slots < numc)
    num2 = num - darken.sum(1) + brighten_mask.sum(1)
    num2c = num2[:, None]

    b_idx = brighten_idx.to(torch.int64).clamp(0, n - 1)
    pos_b = tab.gather(1, b_idx).to(torch.int64)
    sent = torch.full_like(b_idx, n)

    # --- movers INTO [0, num') ---------------------------------------------
    ma_mask = brighten_mask & (pos_b >= num2c)
    w = num2c + slots  # (K, sd)
    w_in = w < numc
    wb_mask = w_in & ~darken.gather(1, w.clamp(0, sd - 1))
    wb_item = arr.gather(1, w.clamp(0, n - 1)).to(torch.int64)
    sent_d = torch.full_like(w, n)
    in_item = torch.cat([torch.where(ma_mask, b_idx, sent),
                         torch.where(wb_mask, wb_item, sent_d)], dim=1)
    in_pos = torch.cat([torch.where(ma_mask, pos_b, sent),
                        torch.where(wb_mask, w, sent_d)], dim=1)
    in_mask = torch.cat([ma_mask, wb_mask], dim=1)

    # --- movers OUT of [0, num') -------------------------------------------
    da_mask = darken & (slots < num2c)
    da_item = arr.gather(1, slots.clamp(max=n - 1).expand(k, sd)).to(torch.int64)
    v = numc + torch.arange(sb, dtype=torch.int64, device=dev)[None]  # (K, sb)
    v_in = v < num2c
    rel = torch.where(brighten_mask, pos_b - numc, torch.full_like(pos_b, sb))
    v_brightened = scatter_drop(
        torch.zeros(k, sb, dtype=torch.bool, device=dev), rel, True
    )
    vd_mask = v_in & ~v_brightened
    vd_item = arr.gather(1, v.clamp(0, n - 1)).to(torch.int64)
    sent_v = torch.full_like(v, n)
    slots_k = slots.expand(k, sd)
    out_item = torch.cat([torch.where(da_mask, da_item, sent_d),
                          torch.where(vd_mask, vd_item, sent_v)], dim=1)
    out_pos = torch.cat([torch.where(da_mask, slots_k, sent_d),
                         torch.where(vd_mask, v, sent_v)], dim=1)
    out_mask = torch.cat([da_mask, vd_mask], dim=1)

    # --- compact to prefix order and swap pairwise -------------------------
    def compact(item, pos, mask):
        size = item.shape[1]
        dest = torch.where(mask, torch.cumsum(mask, dim=1) - 1,
                           torch.full_like(item, size))
        pad = torch.full_like(item, n)
        return scatter_drop(pad, dest, item), scatter_drop(pad, dest, pos)

    bi, bp = compact(in_item, in_pos, in_mask)
    di, dp = compact(out_item, out_pos, out_mask)
    # |in| == |out| always; sentinel (n) entries beyond the pair count drop.
    arr = scatter_drop(scatter_drop(arr, dp, bi), bp, di)
    tab = scatter_drop(scatter_drop(tab, bi, dp), di, bp)
    return BrightState(arr=arr, tab=tab, num=num2)


def bright_buffer(state: BrightState, capacity: int):
    """``(idx, mask)``: idx = arr[:, :capacity] (K, C) int32; mask marks the
    first ``num`` slots of each chain. Padding slots index dark data whose
    contributions callers mask to exactly zero."""
    idx = state.arr[:, :capacity]
    slots = torch.arange(idx.shape[1], device=idx.device)
    return idx, slots[None] < state.num[:, None]


def dark_buffer(state: BrightState, capacity: int):
    """``(idx, mask)`` over the dark tail ``arr[:, num : num + capacity]``.

    The start is clamped to ``[0, N - min(capacity, N)]``, so a buffer wider
    than the dark tail takes bright slots, masked; a ``capacity`` above N
    pads with masked zeros, as the reference does.
    """
    k, n = state.arr.shape
    cap = min(capacity, n)
    start = state.num.clamp(0, n - cap)[:, None]
    offset = start + torch.arange(cap, device=state.arr.device)[None]
    idx = state.arr.gather(1, offset)
    mask = offset >= state.num[:, None]
    if capacity > n:
        idx = torch.nn.functional.pad(idx, (0, capacity - n))
        mask = torch.nn.functional.pad(mask, (0, capacity - n))
    return idx, mask


def check_invariants(state: BrightState) -> bool:
    """Host-side check: every chain's arr is a permutation, tab its inverse,
    and 0 ≤ num ≤ N."""
    arr = state.arr.cpu().numpy()
    tab = state.tab.cpu().numpy()
    num = state.num.cpu().numpy()
    n = arr.shape[1]
    ok = True
    for a, t, m in zip(arr, tab, num):
        ok &= bool(np.all(np.sort(a) == np.arange(n)))
        ok &= bool(np.all(np.sort(t) == np.arange(n)))
        ok &= ok and bool(np.all(a[t] == np.arange(n)))
        ok &= bool(0 <= m <= n)
    return ok
