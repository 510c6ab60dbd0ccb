"""Wrapper for the z-candidate kernel: checks, launch, launch count.

Entry point of the fused z-engine (:func:`repro_torch.core.flymc.
_fused_z_update`). A CUDA tensor goes to ``csrc/z_update.cu`` (or the
wrapper raises); a CPU tensor goes to the plain version in :mod:`.ref`.
Chains are the leading axis of every operand: each chain streams its own
partition array with its own ``(num, key words)``, so a K-chain launch is
bitwise K single-chain launches. Chains may also come in lanes, ``(L, K,
...)`` operands (the sampling service's ``"vmap"`` lanes): one launch for
all L·K chains, bitwise L launches of K chains. A lane's ``(K, N)``
partition block may sit anywhere (its own lane stride), so a stack of
lanes need not be copied together. Candidate selection is integer work on
indices and RNG bits: no gradient.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.z_update.ref import q_threshold_bits, z_candidates_ref

launch_count = 0  # kernel launches through this wrapper (one per call)
_TILE = 2048  # kTile in csrc/z_update.cu
_MAX_N = (1 << 30) - 1  # a status word holds a count in 30 bits
_MAX_CHAINS = 65535  # the launch's grid y: one row of blocks a chain
_CTL_WORDS = 2  # int64 words of per-chain control (ticket, arrivals, epoch)
# The kernel's look-back workspace, one per (device, stream): K rows of
# control words, then K rows of tile status words. Zeroed once and left
# clean by every call (csrc/z_update.cu); grown, zeroed, when a call has
# more chains or tiles than it holds. Calls on one stream run in order and
# share it.
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, int, int]] = {}


def _workspace(dev, di, stream, k, ntiles):
    ws = _workspaces.get((di, stream))
    if ws is None or ws[1] < k or ws[2] < ntiles:
        k_cap = max(k, ws[1] if ws else 0)
        t_cap = max(ntiles, ws[2] if ws else 0)
        buf = torch.zeros(k_cap * (_CTL_WORDS + t_cap), dtype=torch.int64,
                          device=dev)
        ws = (buf, k_cap, t_cap)
        _workspaces[(di, stream)] = ws
    return ws


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"z_candidates: {msg}")


def _refuse(arr, num, key_words, cap):
    """The launch's checks one at a time, once their combined test failed:
    raises naming the first operand the kernel cannot read."""
    dev = arr.device
    for name, a in (("num", num), ("key_words", key_words)):
        _require(a.device == dev, f"{name} is on {a.device}, arr on {dev}")
    _require(arr.dim() in (2, 3) and arr.dtype == torch.int32
             and arr.stride(-1) == 1,
             "arr must be (K, N) or (L, K, N) int32 with unit position "
             "stride")
    lanes = tuple(arr.shape[:-1])
    n = arr.shape[-1]
    _require(n <= _MAX_N, f"arr has N={n}; the kernel's counts hold "
             f"N <= {_MAX_N}")
    _require(num.dtype == torch.int64 and num.shape == lanes
             and num.is_contiguous(), f"num must be contiguous {lanes} int64")
    _require(key_words.dtype == torch.int64
             and key_words.shape == lanes + (2,)
             and key_words.is_contiguous(),
             f"key_words must be contiguous {lanes + (2,)} int64")
    _require(cap > 0, f"capacity must be > 0, got {cap}")
    _require(min(lanes) > 0 and n > 0,
             f"empty partition arrays (shape {tuple(arr.shape)})")
    _require(math.prod(lanes) <= _MAX_CHAINS,
             f"{math.prod(lanes)} chains exceed the launch's {_MAX_CHAINS}")
    raise ValueError("z_candidates: operands refused: " + _build.describe(
        arr=arr, num=num, key_words=key_words))


def _launch(arr, num, key_words, q_db, cand_capacity):
    global launch_count
    cap = int(cand_capacity)
    di = arr.get_device()
    ok = arr.dim() in (2, 3)
    if ok:
        lanes, n = tuple(arr.shape[:-1]), arr.shape[-1]
        ok = (arr.dtype == torch.int32 and arr.stride(-1) == 1
              and num.get_device() == di and num.dtype == torch.int64
              and num.shape == lanes and num.is_contiguous()
              and key_words.get_device() == di
              and key_words.dtype == torch.int64
              and key_words.shape == lanes + (2,)
              and key_words.is_contiguous()
              and min(lanes) > 0 and 0 < n <= _MAX_N and cap > 0
              and math.prod(lanes) <= _MAX_CHAINS)
    if not ok:
        _refuse(arr, num, key_words, cap)
    # One lane (a (K, N) arr) or L lanes of K chains.
    L, k = (1, lanes[0]) if arr.dim() == 2 else lanes
    lane_stride = 0 if arr.dim() == 2 else arr.stride(0)
    lib = _build.library()
    stream = _build.stream_ptr(arr.device)
    ntiles = -(-n // _TILE)
    buf, k_cap, t_cap = _workspace(arr.device, di, stream, L * k, ntiles)
    ctl = buf.data_ptr()
    # One allocation: cand (L·K, cap), then count (L·K,).
    lk = L * k
    buf = torch.empty(lk * (cap + 1), dtype=torch.int32, device=arr.device)
    ptr = buf.data_ptr()
    code = lib.z_candidates_launch(
        arr.data_ptr(), arr.stride(-2), lane_stride, num.data_ptr(),
        key_words.data_ptr(), ptr, ptr + 4 * lk * cap, ctl,
        ctl + 8 * _CTL_WORDS * k_cap, t_cap, k, L, n,
        q_threshold_bits(q_db), cap, stream,
    )
    launch_count += 1
    _build.check(code, "z_candidates")
    return (buf.as_strided(lanes + (cap,), _strides(lanes + (cap,))),
            buf.as_strided(lanes, _strides(lanes), lk * cap))


def _strides(shape):
    out, s = [], 1
    for d in reversed(shape):
        out.append(s)
        s *= d
    return tuple(reversed(out))


def z_candidates(arr, num, key_words, q_db: float, cand_capacity: int):
    """Fused dark→bright candidate selection for K chains, or for L lanes
    of K chains.

    arr (K, N) int32 partition arrays; num (K,) int64 bright counts;
    key_words (K, 2) int64 counter-RNG key words. Returns (cand (K, cap)
    int32 datum ids in arr-position order padded with N, n_cand (K,) int32
    true counts, which may exceed ``cand_capacity``). With lanes every
    operand and output has a leading ``(L, K)`` in place of ``(K,)``.
    """
    if arr.is_cuda:
        return _launch(arr, num, key_words, q_db, cand_capacity)
    if arr.device.type == "cpu":
        return z_candidates_ref(arr, num, key_words, q_db, cand_capacity)
    raise ValueError(f"z_candidates: unsupported device {arr.device}")
