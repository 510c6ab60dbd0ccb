"""Wrapper for the z-candidate kernel: checks, launch, launch count.

Entry point of the fused z-engine (:func:`repro_torch.core.flymc.
_fused_z_update`). A CUDA tensor goes to ``csrc/z_update.cu`` (or the
wrapper raises); a CPU tensor goes to the plain version in :mod:`.ref`.
Chains are the leading axis of every operand: each chain streams its own
partition array with its own ``(num, key words)``, so a K-chain launch is
bitwise K single-chain launches. Candidate selection is integer work on
indices and RNG bits: no gradient.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.z_update.ref import q_threshold_bits, z_candidates_ref

launch_count = 0  # kernel launches through this wrapper (one per call)
_TILE = 2048  # kTile in csrc/z_update.cu


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"z_candidates: {msg}")


def _launch(arr, num, key_words, q_db, cand_capacity):
    global launch_count
    k, n = arr.shape
    dev = arr.device
    _require(arr.dtype == torch.int32 and arr.stride(1) == 1,
             "arr must be (K, N) int32 with unit position stride")
    _require(num.device == dev and num.dtype == torch.int64
             and num.shape == (k,) and num.is_contiguous(),
             f"num must be ({k},) int64 on {dev}")
    _require(key_words.device == dev and key_words.dtype == torch.int64
             and key_words.shape == (k, 2) and key_words.is_contiguous(),
             f"key_words must be contiguous ({k}, 2) int64 on {dev}")
    _require(k > 0 and n > 0 and cand_capacity > 0, "empty operand")
    lib = _build.library()
    cand = torch.empty(k, cand_capacity, dtype=torch.int32, device=dev)
    count = torch.empty(k, dtype=torch.int32, device=dev)
    tiles = torch.empty(k, -(-n // _TILE), dtype=torch.int32, device=dev)
    code = lib.z_candidates_launch(
        arr.data_ptr(), arr.stride(0), num.data_ptr(), key_words.data_ptr(), cand.data_ptr(),
        count.data_ptr(), tiles.data_ptr(), k, n, q_threshold_bits(q_db),
        int(cand_capacity), _build.stream_ptr(dev),
    )
    launch_count += 1
    _build.check(code, "z_candidates")
    return cand, count


def z_candidates(arr, num, key_words, q_db: float, cand_capacity: int):
    """Fused dark→bright candidate selection for K chains.

    arr (K, N) int32 partition arrays; num (K,) int64 bright counts;
    key_words (K, 2) int64 counter-RNG key words. Returns (cand (K, cap)
    int32 datum ids in arr-position order padded with N, n_cand (K,) int32
    true counts, which may exceed ``cand_capacity``).
    """
    if arr.is_cuda:
        return _launch(arr, num, key_words, q_db, cand_capacity)
    if arr.device.type == "cpu":
        return z_candidates_ref(arr, num, key_words, q_db, cand_capacity)
    raise ValueError(f"z_candidates: unsupported device {arr.device}")
