"""AdamW over a model's parameters — the port of :mod:`repro.optim.adamw`.

The reference's update, term for term: m and v read as float32 whatever
their stored dtype, the clip's ``grad_scale`` fused into the gradient read,
the new moments ``m2``, ``v2`` in float32, bias correction as
``(m2/c1) / (sqrt(v2/c2) + eps)`` on those unrounded moments, then decoupled
weight decay inside the learning-rate product, ``p − lr·(step + wd·p)``;
only the stored moments are rounded to their dtype. Not
``torch.optim.AdamW``, which orders the bias correction and the decay
differently and so gives other numbers.

JAX returns new arrays; here the parameters and both moments are updated in
place (under ``torch.no_grad()``), so the step holds no second copy of the
model or of its optimizer state. ``m`` and ``v`` are dicts keyed by the
parameter names of ``model.named_parameters()``, in the config's
``opt_dtype``: float32, or bfloat16 (qwen1.5-110b, arctic-480b: 12 bytes a
parameter of weights, gradient and moments instead of 16). Each tensor is
updated in flat slices of at most :data:`SLICE` elements: the update is
elementwise, so the slices give the same bits as one pass, and a slice's
float32 temporaries stay small beside a vocabulary-sized table.
"""

from __future__ import annotations

import dataclasses

import torch

SLICE = 1 << 26  # elements a slice: 256 MB of float32 temporaries each


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor  # () int32: updates taken so far
    m: dict[str, torch.Tensor]  # first moments, like the parameters
    v: dict[str, torch.Tensor]  # second moments


def adamw_init(params: dict[str, torch.Tensor],
               dtype=torch.float32) -> AdamWState:
    """Zero moments in ``dtype`` (the config's ``opt_dtype``) shaped like
    ``params`` (name → tensor)."""
    dev = next(iter(params.values())).device
    zeros = lambda: {n: torch.zeros(p.shape, dtype=dtype, device=p.device)
                     for n, p in params.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      zeros(), zeros())


def _update(p, g, m, v, c1, c2, lr, b1, b2, eps, weight_decay, grad_scale):
    """One slice, in place: the reference's ``upd``."""
    g = g.to(torch.float32)
    if grad_scale is not None:
        g = g * grad_scale  # fused clip: no scaled copy of the whole tree
    m2, v2 = m.to(torch.float32), v.to(torch.float32)  # m, v when float32
    m2.mul_(b1).add_(g * (1.0 - b1))
    v2.mul_(b2).add_((g * (1.0 - b2)).mul_(g))
    step = (m2 / c1).div_((v2 / c2).sqrt_().add_(eps))
    if m2 is not m:  # stored rounded; the step took the float32 values
        m.copy_(m2)
        v.copy_(v2)
    pf = p.to(torch.float32)  # the parameter itself when it is float32
    pf.sub_(step.add_(pf * weight_decay).mul_(lr))
    if pf is not p:
        p.copy_(pf)


@torch.no_grad()
def adamw_update(
    params: dict[str, torch.Tensor],
    grads: dict[str, torch.Tensor],
    state: AdamWState,
    lr: torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_scale: torch.Tensor | None = None,
) -> AdamWState:
    """One AdamW step over every name of ``params``, in place: the
    parameters, ``state.m``, ``state.v`` and ``state.step`` change. Returns
    ``state``."""
    t = state.step + 1
    tf = t.to(torch.float32)
    c1 = 1.0 - b1**tf
    c2 = 1.0 - b2**tf
    for name, p in params.items():
        flat = [p.view(-1), grads[name].reshape(-1),
                state.m[name].view(-1), state.v[name].view(-1)]
        for i in range(0, p.numel(), SLICE):
            _update(*(a[i:i + SLICE] for a in flat), c1, c2, lr, b1, b2, eps,
                    weight_decay, grad_scale)
    state.step = t
    return state
