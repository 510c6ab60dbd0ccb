"""Wrapper for the fused cross-entropy kernel: checks, launch, launch count,
and the ``FusedCE`` autograd Function.

Entry point of :func:`repro_torch.models.layers.ce_loss_tp` and
:func:`~repro_torch.models.layers.ce_loss_sp`, one call per training step
over the flattened (B·S, d) hidden. A CUDA tensor goes to
``csrc/fused_ce.cu`` (or the wrapper raises): bfloat16 inputs to its
TMA-fed ``wgmma`` kernel, float32 inputs to its CUDA-core kernel; a CPU
tensor goes to the plain version in :mod:`.ref`. ``round_logits`` (bfloat16
inputs only) rounds each logit to bfloat16 before the softmax, as the
reference's bf16 ``ce_loss_tp`` does; without it the logits are the float32
products that the TPU kernel forms.

The reference defines no VJP for its kernel: the training step's gradient is
the autodiff of the loss's checkpointed token chunk. ``FusedCE``'s backward
is that VJP written out, per chunk of ``chunk`` consecutive rows (256 by
default, the TP loss's chunk; the SP loss lays its (B, c) chunks out as
consecutive rows and passes B·c): recompute the chunk's logits in the
compute dtype, softmax over the whole vocabulary in float32,
``dlogits = ḡ·(softmax − onehot)`` cast back to the compute dtype, then
``dx = dlogits·wᵀ`` and ``dw += xᵀ·dlogits``. Those are plain matrix
products, as the reference leaves them to XLA; the (T, V) logits are never
whole in memory.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_ce.ref import fused_ce_ref

launch_count = 0  # kernel launches through this wrapper (one per call)
SPLIT_COLS = 1024  # vocab columns one CTA sweeps (kSplitCols in the .cu)
BWD_CHUNK = 256  # token chunk of the backward: the reference's CE chunk
_TYPES = (torch.float32, torch.bfloat16)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_ce: {msg}")


def _launch(x, w, labels, round_logits):
    global launch_count
    t, d = x.shape
    v = w.shape[1]
    dev = x.device
    _require(x.dtype in _TYPES and w.dtype == x.dtype,
             f"x and w must share one dtype of {_TYPES}")
    _require(w.device == dev and labels.device == dev,
             f"x, w and labels must lie on {dev}")
    _require(x.is_contiguous() and w.is_contiguous(),
             "x and w must be contiguous")
    _require(d > 0 and v > 0 and d % 8 == 0 and v % 8 == 0,
             f"D={d} and V={v} must be positive multiples of 8 (16-byte "
             "loads)")
    _require(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
             "x and w must be 16-byte aligned")
    _require(max(t, d, v) < 2**31,
             f"T={t}, D={d}, V={v} exceed the kernel's int range")
    lab = labels.to(torch.int32).contiguous()
    n_split = -(-v // SPLIT_COLS)
    lib = _build.library()
    part = torch.empty(3, n_split, t, dtype=torch.float32, device=dev)
    lse = torch.empty(t, dtype=torch.float32, device=dev)
    tgt = torch.empty(t, dtype=torch.float32, device=dev)
    code = lib.fused_ce_launch(
        x.data_ptr(), w.data_ptr(), lab.data_ptr(), part.data_ptr(),
        lse.data_ptr(), tgt.data_ptr(), t, d, v,
        int(x.dtype == torch.bfloat16), int(round_logits),
        _build.stream_ptr(dev),
    )
    launch_count += 1
    _build.check(code, "fused_ce")
    return lse, tgt


def lse_and_target(x, w, labels, round_logits: bool = False):
    """Per-token ``logsumexp(x·w)`` and ``(x·w)[label]`` without the (T, V)
    logits in memory.

    x (T, D) and w (D, V) float32 or bfloat16 (one dtype; on the card D and
    V multiples of 8); labels (T,) integers in [0, V) (a label outside gives
    a target logit of 0, as the TPU kernel does). Products are float32;
    ``round_logits`` (bfloat16 inputs only) rounds each to bfloat16 first,
    as the reference's loss does (``layers.ce_loss_tp`` sets it in
    bfloat16). Without it, bfloat16 inputs give ``fused_ce_pallas``'s
    function, kept for parity with the TPU kernel.
    Returns (lse (T,), tgt (T,)) float32.
    """
    _require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
             f"x (T, D) and w (D, V) do not chain: {tuple(x.shape)}, "
             f"{tuple(w.shape)}")
    _require(labels.shape == (x.shape[0],) and not labels.is_floating_point(),
             f"labels must be ({x.shape[0]},) integers")
    _require(not round_logits or x.dtype == torch.bfloat16,
             f"round_logits needs bfloat16 inputs, got {x.dtype}")
    if x.is_cuda:
        return _launch(x, w, labels, round_logits)
    if x.device.type == "cpu":
        return fused_ce_ref(x, w, labels, round_logits)
    raise ValueError(f"fused_ce: unsupported device {x.device}")


def ce_backward(x, w, labels, g, need_x=True, need_w=True,
                chunk: int = BWD_CHUNK):
    """(dx, dw) of Σ_t g_t·nll_t, ``chunk`` rows at a time (see the module
    docstring). dx comes back in x's dtype; dw is summed over the chunks,
    in order, in float32 and returned in w's dtype."""
    dtype = x.dtype
    dx = torch.empty_like(x) if need_x else None
    dw = (torch.zeros(w.shape, dtype=torch.float32, device=w.device)
          if need_w else None)
    for t0 in range(0, x.shape[0], chunk):
        t1 = t0 + chunk
        xc = x[t0:t1]
        p = torch.softmax((xc @ w).float(), dim=-1)
        rows = torch.arange(xc.shape[0], device=x.device)
        p[rows, labels[t0:t1].long()] -= 1.0
        dlog = p.mul_(g[t0:t1, None].float()).to(dtype)
        del p
        if need_x:
            torch.matmul(dlog, w.t(), out=dx[t0:t1])
        if need_w:
            if dw.dtype == dtype:
                dw.addmm_(xc.t(), dlog)
            else:
                dw.add_(xc.t() @ dlog)
    return dx, (None if dw is None else dw.to(w.dtype))


class FusedCE(torch.autograd.Function):
    """Per-token NLL ``lse − tgt`` through the kernel, with the reference's
    chunked VJP as its backward. Differentiable in x and w."""

    @staticmethod
    def forward(ctx, x, w, labels, round_logits, chunk):
        lse, tgt = lse_and_target(x, w, labels, round_logits)
        ctx.save_for_backward(x, w, labels)
        ctx.chunk = chunk
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        x, w, labels = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        dx, dw = ce_backward(x, w, labels, g, need_x, need_w, ctx.chunk)
        return dx, dw, None, None, None


def fused_ce(x, w, labels, round_logits: bool = False,
             chunk: int = BWD_CHUNK):
    """Per-token NLL (T,) float32 = logsumexp(x·w) − (x·w)[label], the
    reference's ``ops.fused_ce``; differentiable in x and w. With
    ``round_logits`` (bfloat16) the forward takes the bf16 logits whose
    gradient the backward returns. ``chunk``: rows a backward chunk (the
    forward is one launch whatever it is)."""
    return FusedCE.apply(x, w, labels, round_logits, chunk)
