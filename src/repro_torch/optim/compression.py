"""Gradient compression for the slow (DCN / pod) axis: int8 + error feedback.

Port of :mod:`repro.optim.compression`. At multi-pod scale the inter-pod
reduction is the slowest link; compressing it 4× (f32 → int8):

    scale   = pmax(absmax(g + err)) over the axes / 127   (shared scale)
    q       = round((g + err) / scale)  ∈ int8 in [-127, 127]
    g_hat   = psum(q) · scale / n                          (int32 accumulate)
    err'    = (g + err) − q · scale                        (error feedback)

Error feedback feeds the accumulated quantization error into the next
step, which restores convergence to within noise of the uncompressed step
(Karimireddy et al. 2019). The sum of the int8 values is taken in int32,
so it is exact and the same on every rank.

The codes and the error state are the reference's bits: its compiled code
takes the scale as absmax · (1/127), the reciprocal's product, and the
error as one fused multiply-subtract, gf − q·scale rounded once; here the
scale is that product and the error is formed in float64 (exact: q has 8
bits, and |gf − q·scale| ≤ scale/2 unless q = 0) and rounded once.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import par as P

SLICE = 1 << 24  # elements of a float64 slice of the error's residual


def quantize(g: torch.Tensor, err: torch.Tensor, axes, par):
    """(q int8, scale () float32, g + err float32): the shared-scale int8
    code of ``g + err`` over ``axes`` (one MAX all-reduce)."""
    gf = g.float() + err
    scale = P.pmax(gf.abs().max(), axes, par) * (1.0 / 127.0)
    scale = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf


def _residual(gf, q, scale):
    """gf − q·scale, rounded once to float32 (float64 slices)."""
    out = torch.empty_like(gf)
    a, b, o = gf.reshape(-1), q.reshape(-1), out.view(-1)
    s = scale.double()
    for i in range(0, o.numel(), SLICE):
        j = i + SLICE
        o[i:j] = (a[i:j].double() - b[i:j].double() * s).float()
    return out


def compressed_pmean(g: torch.Tensor, err: torch.Tensor, axes, par):
    """Compressed mean of ``g`` over the ranks of ``axes``, with error
    feedback. Returns (g_hat float32, err_new float32). With no axes it is
    the identity (and ``err`` passes through untouched), so one code path
    serves single-pod runs."""
    if not axes:
        return g, err
    q, scale, gf = quantize(g, err, axes, par)
    total = P.psum(q.to(torch.int32), axes, par)
    g_hat = total.float() * scale / par.mesh.size_of(axes)
    return g_hat, _residual(gf, q, scale)


def init_error_state(grads: dict[str, torch.Tensor]) -> dict:
    """Zero float32 error state shaped like ``grads`` (or parameters)."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}
