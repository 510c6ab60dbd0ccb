"""Wrapper for the chunked WKV6 kernel: checks, launch, launch count.

Entry point of :func:`repro_torch.models.layers.rwkv_mix`, one call per
RWKV layer per time chunk of a prefill. A CUDA tensor goes to
``csrc/rwkv6_scan.cu`` (or the wrapper raises); a CPU tensor goes to the
plain version in :mod:`.ref`. The kernel has no backward yet: on the card
the wrapper raises under autograd rather than return an untracked result
(the plain CPU version differentiates as written).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_chunked_ref

launch_count = 0  # kernel launches through this wrapper (one per call)
MAX_D = 64  # head dim and chunk length the kernel's shared memory holds
MAX_CHUNK = 64


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rwkv6_scan: {msg}")


def _check(r, k, v, logw, u, state0, chunk):
    _require(r.dim() == 4, f"r must be (B, H, S, D), got {tuple(r.shape)}")
    b, h, s, d = r.shape
    dev = r.device
    _require(b > 0 and h > 0 and s > 0 and d > 0, "empty operand")
    _require(d <= MAX_D, f"head dim {d} > {MAX_D}")
    _require(1 <= chunk <= MAX_CHUNK, f"chunk {chunk} not in [1, {MAX_CHUNK}]")
    c = min(chunk, s)
    _require(s % c == 0, f"sequence {s} is not a multiple of the chunk {c}")
    for name, a in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        _require(a.device == dev and a.dtype == torch.float32
                 and a.shape == (b, h, s, d) and a.is_contiguous(),
                 f"{name} must be contiguous ({b}, {h}, {s}, {d}) float32 "
                 f"on {dev}")
    _require(u.device == dev and u.dtype == torch.float32
             and u.shape == (h, d) and u.is_contiguous(),
             f"u must be contiguous ({h}, {d}) float32 on {dev}")
    if state0 is not None:
        _require(state0.device == dev and state0.dtype == torch.float32
                 and state0.shape == (b, h, d, d) and state0.is_contiguous(),
                 f"state0 must be contiguous ({b}, {h}, {d}, {d}) float32 "
                 f"on {dev}")
    return c


def _launch(r, k, v, logw, u, state0, c):
    global launch_count
    b, h, s, d = r.shape
    dev = r.device
    lib = _build.library()
    y = torch.empty(b, h, s, d, dtype=torch.float32, device=dev)
    state = torch.empty(b, h, d, d, dtype=torch.float32, device=dev)
    code = lib.rwkv6_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None if state0 is None else state0.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, h, s, d, c,
        _build.stream_ptr(dev),
    )
    launch_count += 1
    _build.check(code, "rwkv6_scan")
    return y, state


def rwkv6_scan(r, k, v, logw, u, state0=None, chunk: int = 64):
    """Chunked WKV6 over a sequence from ``state0``.

    r, k, v, logw (B, H, S, D) float32 (logw in [-1, 0)); u (H, D) float32;
    state0 (B, H, D, D) float32 or None (zeros); chunks of c = min(chunk, S)
    with 1 <= chunk <= 64 and S % c == 0; D <= 64. Returns (y (B, H, S, D),
    final state (B, H, D, D)) float32. The model always passes chunk=64 and
    gets a shorter c through S; ``chunk`` is kept for one-to-one parity with
    the reference's ``ops.rwkv6_scan(chunk=)``.
    """
    if r.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    c = _check(r, k, v, logw, u, state0, chunk)
    if r.is_cuda and torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (r, k, v, logw, u, state0)):
        raise NotImplementedError(
            "rwkv6_scan: the CUDA kernel has no backward (ROADMAP queue 1 "
            "item 9b: a WKV6 backward for rwkv6 training)")
    if r.is_cuda:
        return _launch(r, k, v, logw, u, state0, c)
    return rwkv6_chunked_ref(r, k, v, logw, u, state0, c)
