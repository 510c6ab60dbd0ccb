"""Wrapper for the flash-decode kernel: checks, launch, launch count.

Entry point of :func:`repro_torch.models.serving._decode_attend`, one call
per local-attention layer per decode step. A CUDA tensor goes to
``csrc/decode_attention.cu`` (or the wrapper raises); a CPU tensor goes to
the plain version in :mod:`.ref`. No gradient: serving only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

launch_count = 0  # kernel launches through this wrapper (one per call)
_MAX_G = 32  # kMaxG in csrc/decode_attention.cu
_MAX_D = 256  # kMaxD
_MAX_GD = 4096  # kMaxGD: query rows × head dim of one CTA
_THREADS, _MAX_ACC = 512, 16  # kThreads, kMaxAcc
_KV_TYPES = (torch.float32, torch.bfloat16)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_attention: {msg}")


def _launch(q, k, v, pos, t: int, window: int | None):
    global launch_count
    b, h, d = q.shape
    w, hk = k.shape[1], k.shape[2]
    dev = q.device
    _require(q.dtype == torch.float32 and q.is_contiguous(),
             "q must be contiguous (B, H, D) float32")
    _require(k.dtype in _KV_TYPES and v.dtype == k.dtype,
             f"k and v must share one dtype of {_KV_TYPES}")
    for name, a in (("k", k), ("v", v)):
        _require(a.device == dev and a.shape == (b, w, hk, d)
                 and a.is_contiguous(),
                 f"{name} must be contiguous ({b}, {w}, {hk}, {d}) on {dev}")
    _require(pos.device == dev and pos.dtype == torch.int32
             and pos.shape == (w,) and pos.is_contiguous(),
             f"pos must be contiguous ({w},) int32 on {dev}")
    _require(b > 0 and w > 0 and hk > 0 and h % hk == 0,
             f"H={h} must be a positive multiple of Hk={hk}, W > 0")
    g = h // hk
    _require(0 < d <= _MAX_D and d % 8 == 0,
             f"D={d} must be a multiple of 8 up to {_MAX_D} (16-byte loads)")
    _require(g <= _MAX_G and g * d <= _MAX_GD
             and -(-g // (_THREADS // d)) <= _MAX_ACC,
             f"G={g} query rows × D={d} exceed the kernel's limits "
             f"(G <= {_MAX_G}, G·D <= {_MAX_GD})")
    _require(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
             "k and v must be 16-byte aligned")
    _require(window is None or window > 0, "window must be positive")
    lib = _build.library()
    out = torch.empty(b, h, d, dtype=torch.float32, device=dev)
    m = torch.empty(b, hk, g, dtype=torch.float32, device=dev)
    l = torch.empty(b, hk, g, dtype=torch.float32, device=dev)
    code = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, hk, g, d, w, int(t), int(window or 0), int(window is not None),
        int(k.dtype == torch.bfloat16), _build.stream_ptr(dev),
    )
    launch_count += 1
    _build.check(code, "decode_attention")
    return out, m, l


def decode_attention(q, k, v, pos, t: int, window: int | None = None):
    """Flash-decode of one query token per batch row over a ring KV cache.

    q (B, H, D) float32; k, v (B, W, Hk, D) float32 or bfloat16; pos (W,)
    int32 absolute slot positions (-1 = empty); t the query's position (a
    host int); window the sliding window or None. Returns (out (B, H, D),
    m (B, Hk, G), l (B, Hk, G)) float32, G = H / Hk.
    """
    if q.is_cuda:
        return _launch(q, k, v, pos, t, window)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos, t, window)
    raise ValueError(f"decode_attention: unsupported device {q.device}")
