"""Parameter declarations, their placement on a mesh, and their init rule.

The port's counterpart of the part of :mod:`repro.distributed.par` that
declares and initialises weights (``WDef``, ``init_param``, ``init_tree``).
A layer's weights are the ``nn.Parameter`` s of a :class:`Params` module,
declared by a dict of :class:`WDef` s with the same names and shapes as the
reference's (a nested dict is a child :class:`Params`, as the reference's
MoE ``ffn`` nests its ``dense`` FFN). Each declaration also carries the
reference's placement hints, ``tp_dim`` and ``fsdp_pref``; each
:class:`Params` holds the :class:`~repro_torch.distributed.par.WSpec` that
:func:`~repro_torch.distributed.par.resolve` makes of them for its mesh
(``specs``), and allocates each weight at the spec's local shape: the whole
weight on one device, this rank's shard on a mesh.

Init rule (``par.py::init_param``): ``zeros``, ``ones`` or ``const``
(``init_scale``); otherwise ``init_scale / sqrt(fan_in) · N(0, 1)`` with
``fan_in = shape[-2]`` (``shape[-1]`` for a vector) of the logical shape,
drawn in float32 from an explicit ``torch.Generator``. A sharded weight
draws its whole logical tensor from the same generator and keeps its
slice, so a sharded model is the single-device model of the same seed, cut
up, bit for bit. The reference draws from jax keys, so the two packages'
weights differ for one seed: the parity tests hand the reference's weights
over with :func:`repro_torch.convert.lm_params`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

from repro_torch.distributed.par import local_slice, resolve_tree


@dataclasses.dataclass(frozen=True)
class WDef:
    """Shape, init rule and placement hints of one parameter: ``tp_dim``
    is the dimension sharded over the ``model`` axis in compute (vocab,
    column or row parallel), ``fsdp_pref`` the dimensions that may be
    sharded at rest over the other axes, in order of preference."""

    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | const | scaled
    init_scale: float = 1.0
    tp_dim: int | None = None
    fsdp_pref: tuple[int, ...] = (0,)


class Params(nn.Module):
    """A layer's weights, one ``nn.Parameter`` per :class:`WDef`, each at
    its spec's local shape (``specs``: name → ``WSpec``, nested like
    ``defs``; by default every weight whole, as on one device).

    Parameters are allocated uninitialised on ``device`` in ``dtype``;
    :func:`init_params` draws them. They start with ``requires_grad=False``,
    which serving keeps; the trainer switches gradients on with
    ``model.requires_grad_(True)``.
    """

    def __init__(self, defs: dict[str, WDef | dict], device, dtype,
                 specs: dict | None = None):
        super().__init__()
        specs = resolve_tree(defs, {}, None) if specs is None else specs
        self.defs = {n: d for n, d in defs.items() if isinstance(d, WDef)}
        self.specs = {n: specs[n] for n in self.defs}
        for name, d in defs.items():
            if isinstance(d, dict):  # a nested group (an MoE's dense FFN)
                self.add_module(name, Params(d, device, dtype, specs[name]))
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(self.specs[name].local_shape, device=device,
                                dtype=dtype),
                    requires_grad=False))


# A leaf of this many elements or more (arctic-480b's (128, 7168, 4864)
# expert matrices) draws its normals one leading slice at a time: one
# float32 draw of the whole leaf is a 17.9 GB transient beside 55 GB of
# bf16 weights on an 80 GB card. Every leaf of the other archs is smaller
# and keeps its one draw (and its bits).
SLICED_NUMEL = 2**31


def init_param(p: torch.Tensor, d: WDef, gen: torch.Generator,
               keep: Callable[[torch.Tensor], torch.Tensor] | None = None
               ) -> None:
    """Fill ``p`` in place by ``d``'s rule; normals are drawn in float32 on
    ``p``'s device from ``gen`` (which must live on that device), by leading
    slices for a leaf of ``SLICED_NUMEL`` elements or more. ``keep`` maps
    the drawn logical tensor to ``p``'s shard (a sharded weight)."""
    if d.init == "zeros":
        p.zero_()
    elif d.init == "ones":
        p.fill_(1.0)
    elif d.init == "const":
        p.fill_(d.init_scale)
    else:
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.init_scale / math.sqrt(max(fan_in, 1))
        if math.prod(d.shape) < SLICED_NUMEL:
            z = torch.randn(d.shape, generator=gen, device=p.device,
                            dtype=torch.float32)
            z.mul_(scale)
            p.copy_(z if keep is None else keep(z))
            return
        if keep is not None:
            raise NotImplementedError(
                f"a sharded leaf of {math.prod(d.shape)} elements: the "
                "sharded init draws each leaf whole")
        for row in p:  # one leading slice at a time
            z = torch.randn(row.shape, generator=gen, device=p.device,
                            dtype=torch.float32)
            row.copy_(z.mul_(scale))


@torch.no_grad()
def init_params(model: nn.Module, gen: torch.Generator,
                par=None) -> None:
    """Draw every :class:`Params` weight of ``model``, in module order;
    under a sharded ``par`` each weight keeps its shard of the logical
    draw."""
    for mod in model.modules():
        if isinstance(mod, Params):
            for name, d in mod.defs.items():
                spec = mod.specs[name]
                keep = (None if spec.local_shape == spec.shape
                        else lambda z, s=spec: local_slice(z, s, par))
                init_param(getattr(mod, name), d, gen, keep)
