"""Wrapper for the flash-decode kernel: checks, launch, launch count, and
the merge of the kernel's partial results across ranks.

Entry point of :func:`repro_torch.models.serving._decode_attend`, one call
per local-attention layer per decode step (on a mesh, one per rank on its
block of the ring, merged by :func:`merge_across`). A CUDA tensor goes to
``csrc/decode_attention.cu`` (or the wrapper raises): the ring cut into
splits by :func:`plan_splits`, one CTA per (batch row, KV head, split),
then a merge in split order; a CPU tensor goes to the plain version in
:mod:`.ref`. Serving only: the kernel has no backward,
so on the card the wrapper raises under autograd rather than return an
untracked result.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.distributed import par as P
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

launch_count = 0  # kernel launches through this wrapper (one per call)
_MAX_G = 32  # kMaxG in csrc/decode_attention.cu
_MAX_D = 256  # kMaxD
_MAX_GD = 4096  # kMaxGD: query rows × head dim of one CTA
_KV_TYPES = (torch.float32, torch.bfloat16)
MIN_SPLIT = 32  # ring slots a split takes at least


def plan_splits(bh: int, w: int, sms: int) -> tuple[int, int]:
    """(slots per split, number of splits) of a ring of ``w`` slots for
    ``bh`` = B·Hk (batch row, KV head) pairs: enough splits that the
    (B·Hk, n_split) grid fills the card's ``sms`` SMs, none shorter than
    ``MIN_SPLIT`` slots (below that the merge reads more than a split
    computes). A small ring is one split; the last split may be ragged."""
    want = -(-sms // bh)
    split = max(MIN_SPLIT, -(-w // want))
    return split, -(-w // split)


@functools.cache
def sm_count(index: int | None) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    _require(g <= _MAX_G and g * d <= _MAX_GD,
             f"G={g} query rows × D={d} exceed the kernel's limits "
             f"(G <= {_MAX_G}, G·D <= {_MAX_GD})")
    _require(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
             "k and v must be 16-byte aligned")
    _require(window is None or window > 0, "window must be positive")
    lib = _build.library()
    split, n_split = plan_splits(b * hk, w, sm_count(dev.index))
    part = torch.empty(n_split, b, hk, g, d + 2, dtype=torch.float32,
                       device=dev)
    out = torch.empty(b, h, d, dtype=torch.float32, device=dev)
    m = torch.empty(b, hk, g, dtype=torch.float32, device=dev)
    l = torch.empty(b, hk, g, dtype=torch.float32, device=dev)
    code = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        part.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, hk, g, d, w, split, n_split, int(t), int(window or 0),
        int(window is not None), int(k.dtype == torch.bfloat16),
        _build.stream_ptr(dev),
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
        if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
            raise NotImplementedError(
                "decode_attention: the CUDA kernel has no backward, and none "
                "is planned: the reference defines no VJP for this kernel "
                "(decode_attention is a serving kernel)")
        return _launch(q, k, v, pos, t, window)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos, t, window)
    raise ValueError(f"decode_attention: unsupported device {q.device}")


def merge_partials(out, m, l, pmax, psum):
    """The flash-decode of several blocks of one ring merged into the
    whole ring's: each block's kernel output ``out`` (..., B, H, D) and its
    statistics ``m``, ``l`` (..., B, Hk, G), with ``pmax`` and ``psum``
    the reductions over the blocks. In this order: m_g = pmax(m),
    w = l·e^{m − m_g}, L = psum(w), out = psum(out·w) / max(L, 1e-30).
    A wholly masked block (m = −1e30, l its slots, out the mean of its V)
    weighs e^{−1e30 − m_g} = 0 beside a block that holds a valid slot;
    when every block is masked, the result is the mean of every V, as
    the kernel's over the whole ring. Returns (B, H, D) float32."""
    d = out.shape[-1]
    m_g = pmax(m)
    w = l * torch.exp(m - m_g)
    tot = psum(w)
    o = psum(out.reshape(*m.shape, d) * w[..., None])
    o = o / torch.clamp(tot, min=1e-30)[..., None]
    return o.reshape(*o.shape[:-3], -1, d)


def merge_across(out, m, l, axes, par):
    """:func:`merge_partials` over the ranks of ``axes`` (each rank's
    block of a sequence-sharded ring): one pmax and two psums through
    :mod:`repro_torch.distributed.par`."""
    return merge_partials(out, m, l, lambda x: P.pmax(x, axes, par),
                          lambda x: P.psum(x, axes, par))


def merge_stacked(out, m, l):
    """:func:`merge_partials` of blocks stacked on a leading axis (out
    (n, B, H, D), m and l (n, B, Hk, G)) in one process: what the ranks'
    merge computes, for checking it against the whole ring."""
    return merge_partials(out, m, l, lambda x: x.amax(0),
                          lambda x: x.sum(0))
