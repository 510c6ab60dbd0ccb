"""Wrappers for the chunked WKV6 kernels: checks, launch, launch counts.

Entry point of :func:`repro_torch.models.layers.rwkv_mix`, one call per
RWKV layer per time chunk of a prefill or training forward. A CUDA tensor
goes to ``csrc/rwkv6_scan.cu`` (or the wrapper raises); a CPU tensor goes
to the plain versions in :mod:`.ref`.

Without a graph (serving) a call is one launch of ``rwkv6_scan_kernel``.
Under autograd it goes through :class:`RWKV6Scan`: its forward is one
launch of the same kernel that also writes the state entering each WKV
chunk (y and the final state are the same bits), and its backward,
:func:`rwkv6_scan_backward`, one launch of ``rwkv6_scan_bwd_kernel``,
which walks the chunks in reverse from those states and writes dr, dk, dv,
dlogw, du and dstate0 itself. On the CPU the same Function runs
:func:`.ref.rwkv6_chunked_ref` and :func:`.ref.rwkv6_bwd_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_bwd_ref, rwkv6_chunked_ref

launch_count = 0  # kernel launches: one per forward, one per backward
bwd_launch_count = 0  # of which backward kernel launches
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


def _ptr(a):
    return None if a is None else a.data_ptr()


def _launch(r, k, v, logw, u, state0, c, save_states: bool = False):
    """The forward kernel; with ``save_states`` also returns the state
    entering each chunk, (B, H, S/c, D, D)."""
    global launch_count
    b, h, s, d = r.shape
    dev = r.device
    lib = _build.library()
    y = torch.empty(b, h, s, d, dtype=torch.float32, device=dev)
    state = torch.empty(b, h, d, d, dtype=torch.float32, device=dev)
    states = (torch.empty(b, h, s // c, d, d, dtype=torch.float32, device=dev)
              if save_states else None)
    code = lib.rwkv6_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), _ptr(state0), y.data_ptr(), state.data_ptr(),
        _ptr(states), b, h, s, d, c, _build.stream_ptr(dev),
    )
    launch_count += 1
    _build.check(code, "rwkv6_scan")
    return (y, state, states) if save_states else (y, state)


def _launch_bwd(r, k, v, logw, u, states, dy, d_state, c, want_dstate0):
    global launch_count, bwd_launch_count
    b, h, s, d = r.shape
    dev = r.device
    _require(states.shape == (b, h, s // c, d, d) and states.is_contiguous(),
             f"states must be contiguous ({b}, {h}, {s // c}, {d}, {d})")
    for name, a in (("dy", dy), ("d_state", d_state)):
        want = (b, h, s, d) if name == "dy" else (b, h, d, d)
        _require(a is None or (a.device == dev and a.dtype == torch.float32
                               and a.shape == want and a.is_contiguous()),
                 f"{name} must be contiguous {want} float32 on {dev}")
    lib = _build.library()
    dr, dk, dv, dlogw = (torch.empty(b, h, s, d, dtype=torch.float32,
                                     device=dev) for _ in range(4))
    du = torch.empty(h, d, dtype=torch.float32, device=dev)
    dstate0 = (torch.empty(b, h, d, d, dtype=torch.float32, device=dev)
               if want_dstate0 else None)
    code = lib.rwkv6_scan_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), states.data_ptr(), dy.data_ptr(), _ptr(d_state),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(),
        du.data_ptr(), _ptr(dstate0), b, h, s, d, c, _build.stream_ptr(dev),
    )
    launch_count += 1
    bwd_launch_count += 1
    _build.check(code, "rwkv6_scan_bwd")
    return dr, dk, dv, dlogw, du, dstate0


def rwkv6_scan_backward(r, k, v, logw, u, states, dy, d_state=None,
                        chunk: int = 64, want_dstate0: bool = True):
    """The backward of :func:`rwkv6_scan`: ``dy`` (B, H, S, D) and
    ``d_state`` (B, H, D, D) or None (zeros) are the cotangents of y and
    the final state, ``states`` the forward's states entering each chunk.
    Returns (dr, dk, dv, dlogw, du (H, D), dstate0 (B, H, D, D), or None
    unless ``want_dstate0``), float32."""
    c = min(chunk, r.shape[2])
    if r.is_cuda:
        return _launch_bwd(r, k, v, logw, u, states, dy, d_state, c,
                           want_dstate0)
    if r.device.type == "cpu":
        grads = rwkv6_bwd_ref(r, k, v, logw, u, states, dy, d_state, c)
        return (*grads[:5], grads[5] if want_dstate0 else None)
    raise ValueError(f"rwkv6_scan: unsupported device {r.device}")


class RWKV6Scan(torch.autograd.Function):
    """The chunked WKV with its reverse-chunk backward."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0, c):
        if r.is_cuda:
            y, state, states = _launch(r, k, v, logw, u, state0, c, True)
        else:
            y, state, states = rwkv6_chunked_ref(r, k, v, logw, u, state0,
                                                 c, return_states=True)
        ctx.save_for_backward(r, k, v, logw, u, states)
        ctx.c = c
        ctx.has_state0 = state0 is not None
        # an unused final state's cotangent arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, d_state):
        r, k, v, logw, u, states = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.contiguous()
        if d_state is not None:
            d_state = d_state.contiguous()
        want = ctx.has_state0 and ctx.needs_input_grad[5]
        grads = rwkv6_scan_backward(r, k, v, logw, u, states, dy, d_state,
                                    ctx.c, want)
        return (*(g if need else None for g, need in
                  zip(grads, ctx.needs_input_grad)), None)


def rwkv6_scan(r, k, v, logw, u, state0=None, chunk: int = 64):
    """Chunked WKV6 over a sequence from ``state0``.

    r, k, v, logw (B, H, S, D) float32 (logw in [-1, 0)); u (H, D) float32;
    state0 (B, H, D, D) float32 or None (zeros); chunks of c = min(chunk, S)
    with 1 <= chunk <= 64 and S % c == 0; D <= 64. Returns (y (B, H, S, D),
    final state (B, H, D, D)) float32, differentiable in every input
    (through :class:`RWKV6Scan`) where one requires a gradient. The model
    always passes chunk=64 and gets a shorter c through S; ``chunk`` is
    kept for one-to-one parity with the reference's
    ``ops.rwkv6_scan(chunk=)``.
    """
    if r.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    c = _check(r, k, v, logw, u, state0, chunk)
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (r, k, v, logw, u, state0)):
        return RWKV6Scan.apply(r, k, v, logw, u, state0, c)
    if r.is_cuda:
        return _launch(r, k, v, logw, u, state0, c)
    return rwkv6_chunked_ref(r, k, v, logw, u, state0, c)
