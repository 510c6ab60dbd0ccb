"""Parameter declarations and their init rule, single device.

The port's counterpart of the part of :mod:`repro.distributed.par` that
declares and initialises weights (``WDef``, ``init_param``, ``init_tree``).
Gathers, psums and the ``Par`` mesh axes are the identity on one device and
are not ported: a layer's weights are the ``nn.Parameter`` s of a
:class:`Params` module, declared by a dict of :class:`WDef` s with the same
names and shapes as the reference's.

Init rule (``par.py::init_param``): ``zeros``, ``ones`` or ``const``
(``init_scale``); otherwise ``init_scale / sqrt(fan_in) · N(0, 1)`` with
``fan_in = shape[-2]`` (``shape[-1]`` for a vector), drawn in float32 from
an explicit ``torch.Generator``. The reference draws from jax keys, so the
two packages' weights differ for one seed: the parity tests hand the
reference's weights over with :func:`repro_torch.convert.lm_params`.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class WDef:
    """Shape and init rule of one parameter."""

    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | const | scaled
    init_scale: float = 1.0


class Params(nn.Module):
    """A layer's weights, one ``nn.Parameter`` per :class:`WDef`.

    Parameters are allocated uninitialised on ``device`` in ``dtype``;
    :func:`init_params` draws them. Serving needs no gradients, so none is
    tracked.
    """

    def __init__(self, defs: dict[str, WDef], device, dtype):
        super().__init__()
        self.defs = defs
        for name, d in defs.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(d.shape, device=device, dtype=dtype),
                requires_grad=False))


def init_param(p: torch.Tensor, d: WDef, gen: torch.Generator) -> None:
    """Fill ``p`` in place by ``d``'s rule; normals are drawn in float32 on
    ``p``'s device from ``gen`` (which must live on that device)."""
    if d.init == "zeros":
        p.zero_()
    elif d.init == "ones":
        p.fill_(1.0)
    elif d.init == "const":
        p.fill_(d.init_scale)
    else:
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.init_scale / math.sqrt(max(fan_in, 1))
        z = torch.randn(d.shape, generator=gen, device=p.device,
                        dtype=torch.float32)
        p.copy_(z.mul_(scale))


@torch.no_grad()
def init_params(model: nn.Module, gen: torch.Generator) -> None:
    """Draw every :class:`Params` weight of ``model``, in module order."""
    for mod in model.modules():
        if isinstance(mod, Params):
            for name, d in mod.defs.items():
                init_param(getattr(mod, name), d, gen)
