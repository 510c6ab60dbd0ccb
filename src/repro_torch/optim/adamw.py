"""AdamW over a model's parameters — the port of :mod:`repro.optim.adamw`.

The reference's update, term for term: m and v in float32 whatever the
parameter dtype, the clip's ``grad_scale`` fused into the gradient read,
bias correction as ``(m/c1) / (sqrt(v/c2) + eps)``, then decoupled weight
decay inside the learning-rate product, ``p − lr·(step + wd·p)``. Not
``torch.optim.AdamW``, which orders the bias correction and the decay
differently and so gives other numbers.

JAX returns new arrays; here the parameters and both moments are updated in
place (under ``torch.no_grad()``), so the step holds no second copy of the
model or of its optimizer state. ``m`` and ``v`` are float32 dicts keyed by
the parameter names of ``model.named_parameters()`` (every config's
``opt_dtype`` is float32).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor  # () int32: updates taken so far
    m: dict[str, torch.Tensor]  # first moments, like the parameters
    v: dict[str, torch.Tensor]  # second moments


def adamw_init(params: dict[str, torch.Tensor]) -> AdamWState:
    """Zero float32 moments shaped like ``params`` (name → tensor)."""
    dev = next(iter(params.values())).device
    zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      zeros(), zeros())


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
        g = grads[name].to(torch.float32)
        if grad_scale is not None:
            g = g * grad_scale  # fused clip: no scaled copy of the whole tree
        m, v = state.m[name], state.v[name]
        m.mul_(b1).add_(g * (1.0 - b1))
        v.mul_(b2).add_((g * (1.0 - b2)).mul_(g))
        step = (m / c1).div_((v / c2).sqrt_().add_(eps))
        pf = p.to(torch.float32)  # the parameter itself when it is float32
        pf.sub_(step.add_(pf * weight_decay).mul_(lr))
        if pf is not p:
            p.copy_(pf)
    state.step = t
    return state
