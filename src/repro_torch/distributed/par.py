"""Parallelism primitives of the LM stack on ``torch.distributed``.

Port of :mod:`repro.distributed.par`. Model code is written once against
:class:`Par` and runs in two modes, as the reference's:

  * trivial ``Par()``: no mesh axes; every collective helper is the
    identity (one device).
  * sharded ``Par(dp=("pod", "data"), mp="model", mesh=...)``: one process
    a rank of a :class:`~repro_torch.launch.mesh.Mesh`; the helpers call
    the counted collectives of :mod:`repro_torch.distributed.comm` on the
    mesh's process group of the named axes.

Under autograd each helper has the transpose that makes every rank's
gradient the gradient of the one global loss:

  * ``all_gather``'s backward is the ``reduce_scatter`` of the cotangent,
    and the other way round;
  * ``psum`` of a value that is replicated after it (the loss's sums, the
    vocab-parallel cross-entropy's merge) passes its cotangent through
    unchanged, as :func:`~repro_torch.distributed.comm.sum_across` does.
    The reference's ``psum`` (inside ``shard_map(check_vma=False)``)
    transposes to another ``psum``, which multiplies its gradients by the
    device count (ROADMAP queue 3 item 3); the port does not copy that;
  * ``pmax`` carries no gradient (the reference stops it, layers.py:804);
  * :func:`tp_entry`, the Megatron counterpart of ``psum``, is the
    identity whose cotangent is summed over ``model``. A TP-mode branch
    (head-, channel- or column-parallel over ``model``) takes its input
    through it: the input is replicated over ``model``, and each rank's
    branch returns only its part of the input's cotangent;
  * :func:`replicated_grad` scales a gathered weight's cotangent by 1/mp
    where every model rank computes the whole of its gradient (a TP-mode
    norm scale on the replicated stream): the reduce-scatter (or
    ``sync_grads``'s psum) over ``model`` then adds mp equal copies into
    one.

Parameter placement is described per leaf by :class:`WSpec`, resolved
from a :class:`~repro_torch.models.params.WDef` per mesh by :func:`resolve`
(the reference's rule, windows and tie order):

  * ``tp_dim``: dimension sharded over the ``model`` axis that stays
    sharded in compute (column/row parallel MLP, vocab-parallel embedding
    and head);
  * ``fsdp_dim``: dimension sharded at rest over ``fsdp_axes`` (ZeRO-3),
    all-gathered just in time for compute (:func:`gather_param`, which
    casts first), so that the backward reduce-scatters its gradient;
  * ``sync``: mesh axes that neither covers. The weight is replicated over
    them, its gradient needs one explicit psum (:func:`sync_grads`), and
    the global norm divides its square by ``replicas``.

A rank's shard of a logical tensor is :func:`local_slice`; the logical
tensor is :func:`gather_logical` of the shards (the checkpointer's and the
converter's tools). Both take a :class:`WSpec` or a :class:`PSpec`, the
placement of an activation or a serving cache (the reference's
``PartitionSpec``: the axes each dimension is split over).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.distributed import comm


@dataclasses.dataclass(frozen=True)
class Par:
    """Axis context a model function runs under. ``dp``: the batch/FSDP
    axes, e.g. ("pod", "data"); ``mp``: the model axis; their sizes;
    ``mesh``: the :class:`~repro_torch.launch.mesh.Mesh` whose process
    groups the collectives use (None for the trivial ``Par()``)."""

    dp: tuple[str, ...] = ()
    mp: str | None = None
    dp_size: int = 1
    mp_size: int = 1
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def all_axes(self) -> tuple[str, ...]:
        return self.dp + ((self.mp,) if self.mp else ())

    @property
    def mp_axes(self) -> tuple[str, ...]:
        return (self.mp,) if self.mp else ()


# ---------------------------------------------------------------------------
# Collectives (identities without axes)
# ---------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return comm.all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return comm.reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return comm.reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g, ctx.dim, ctx.group), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def scale_grad(x, s: float):
    """``x`` itself, whose cotangent is multiplied by ``s`` on its way
    back: a term that several ranks compute alike enters the sum of their
    backwards once (``transformer.loss_fn``'s MoE term)."""
    return _ScaleGrad.apply(x, s) if _tracked(x) else x


def _tracked(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def psum(x, axes, par: Par):
    """Σ over the ranks of ``axes``; the cotangent of the (replicated) sum
    passes through as it is."""
    if not axes:
        return x
    return comm.sum_across(x, par.mesh.group(axes))


def tp_entry(x, par: Par):
    """``x`` itself (replicated over ``model``); under autograd its
    cotangent is summed over ``model`` (Megatron's f; :func:`psum` is its
    g). Without ``model`` ranks, or with one, nothing is added."""
    if par.mp_size <= 1 or not _tracked(x):
        return x
    return comm.grad_sum_across(x, par.mesh.group(par.mp_axes))


def replicated_grad(w, par: Par):
    """``w`` itself; under autograd its cotangent is divided by the
    ``model`` ranks, so that the sum over them of mp equal gradients (a
    weight every model rank uses alike on replicated activations) is one
    gradient. The identity with one model rank."""
    if par.mp_size <= 1:
        return w
    return scale_grad(w, 1.0 / par.mp_size)


def pmax(x, axes, par: Par):
    """Max over the ranks of ``axes``, without a gradient."""
    if not axes:
        return x
    return comm.all_reduce_max(x.detach(), par.mesh.group(axes))


def all_gather(x, axes, dim: int, par: Par):
    """Tiled all-gather along ``dim`` over ``axes`` (shards in the axes'
    row-major rank order); its backward reduce-scatters."""
    if not axes:
        return x
    group = par.mesh.group(axes)
    if _tracked(x):
        return _AllGather.apply(x, dim, group)
    return comm.all_gather(x, dim, group)


def reduce_scatter(x, axes, dim: int, par: Par):
    """Tiled reduce-scatter (sum, then this rank's block of ``dim``) over
    ``axes``; its backward all-gathers."""
    if not axes:
        return x
    group = par.mesh.group(axes)
    if _tracked(x):
        return _ReduceScatter.apply(x, dim, group)
    return comm.reduce_scatter(x, dim, group)


def axis_index(axis: str | None, par: Par) -> int:
    """This rank's coordinate along ``axis`` (0 without one)."""
    if axis is None:
        return 0
    return par.mesh.index((axis,))


# ---------------------------------------------------------------------------
# Weight placement specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WSpec:
    """Resolved placement of one parameter on one mesh."""

    shape: tuple[int, ...]  # global logical shape
    tp_dim: int | None = None  # dim sharded over `model` in compute
    fsdp_dim: int | None = None  # dim sharded at rest, gathered for compute
    fsdp_axes: tuple[str, ...] = ()
    sync: tuple[str, ...] = ()  # axes needing explicit grad psum
    local_shape: tuple[int, ...] = ()  # this rank's shard
    replicas: int = 1  # ranks holding the same shard (over `sync`)


def resolve(defn, mesh_sizes: dict[str, int], mp_axis: str | None,
            exclude_fsdp: tuple[str, ...] = ()) -> WSpec:
    """Pick fsdp axes for a param given the mesh (the largest dividing
    contiguous window of (pod, data[, model]); ties drop ``pod`` first).

    ``exclude_fsdp`` removes axes from sharding candidates: the pod axis
    when its gradient reduction is compressed (``optim.compression``);
    those axes land in ``sync`` instead."""
    axes_order = [a for a in ("pod", "data")
                  if a in mesh_sizes and a not in exclude_fsdp]
    if defn.tp_dim is None and mp_axis in mesh_sizes:
        axes_order = axes_order + [mp_axis]
    size_of = lambda c: math.prod(mesh_sizes[a] for a in c) if c else 1
    candidates: list[tuple[str, ...]] = []
    n = len(axes_order)
    for width in range(n, 0, -1):
        for start in range(n - width, -1, -1):
            combo = tuple(axes_order[start:start + width])
            if combo not in candidates:
                candidates.append(combo)
    candidates.sort(key=size_of, reverse=True)  # stable: ties keep order
    candidates.append(())

    best: tuple[tuple[str, ...], int | None] = ((), None)
    for combo in candidates:
        size = size_of(combo)
        for dim in defn.fsdp_pref:
            if defn.tp_dim == dim:
                continue
            if defn.shape[dim] % size == 0:
                best = (combo, dim if combo else None)
                break
        if best[0]:
            break
    fsdp_axes, fsdp_dim = best
    tp_dim = defn.tp_dim if mp_axis else None
    covered = set(fsdp_axes) | ({mp_axis} if tp_dim is not None else set())
    sync = tuple(a for a in mesh_sizes if a not in covered)
    local = list(defn.shape)
    if tp_dim is not None:
        local[tp_dim] //= mesh_sizes.get(mp_axis, 1)
    if fsdp_dim is not None:
        local[fsdp_dim] //= size_of(fsdp_axes)
    return WSpec(shape=tuple(defn.shape), tp_dim=tp_dim, fsdp_dim=fsdp_dim,
                 fsdp_axes=fsdp_axes, sync=sync, local_shape=tuple(local),
                 replicas=math.prod(mesh_sizes.get(a, 1) for a in sync))


def resolve_tree(defs: dict, mesh_sizes: dict[str, int], mp_axis,
                 exclude_fsdp: tuple[str, ...] = ()) -> dict:
    """:func:`resolve` over a (nested) dict of WDefs."""
    return {k: (resolve_tree(v, mesh_sizes, mp_axis, exclude_fsdp)
                if isinstance(v, dict)
                else resolve(v, mesh_sizes, mp_axis, exclude_fsdp))
            for k, v in defs.items()}


def gather_param(w: torch.Tensor, spec: WSpec, dtype, par: Par):
    """Cast, then all-gather the fsdp axes (the JIT weight gather of
    ZeRO-3). Casting before the gather halves a bf16 step's bytes; the
    cast's backward returns the reduce-scattered gradient to ``w``'s
    dtype."""
    w = w.to(dtype)
    if spec.fsdp_dim is None or not spec.fsdp_axes:
        return w
    return all_gather(w, spec.fsdp_axes, spec.fsdp_dim, par)


def sync_grads(grads: dict[str, torch.Tensor], specs: dict[str, WSpec],
               par: Par, compress_axes: tuple[str, ...] = (),
               err: dict | None = None) -> dict[str, torch.Tensor]:
    """The explicit psum over ``sync`` of each replicated weight's
    gradient (name → tensor, as ``model.named_parameters()``). The part of
    ``sync`` in ``compress_axes`` is instead
    :func:`~repro_torch.optim.compression.compressed_pmean` times those
    axes' size (the loss already averages over the global batch), with the
    error state ``err`` updated in place. On one device every ``sync`` is
    empty and this is the identity."""
    from repro_torch.optim.compression import compressed_pmean

    out = {}
    for name, g in grads.items():
        spec = specs[name]
        comp = tuple(a for a in spec.sync if a in compress_axes)
        g = psum(g, tuple(a for a in spec.sync if a not in compress_axes),
                 par)
        if comp:
            g, err[name] = compressed_pmean(g, err[name], comp, par)
            g = g * par.mesh.size_of(comp)
        out[name] = g
    return out


# ---------------------------------------------------------------------------
# Logical tensors and shards
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PSpec:
    """The placement of a tensor that is not a weight (a serving cache's
    leaf, a step's output): ``dims[i]`` the mesh axes dimension ``i`` is
    split over, in mesh order, () where it is whole. The reference's
    ``PartitionSpec``; the logical tensor's shape is each local dimension
    times its axes' size."""

    dims: tuple[tuple[str, ...], ...]

    def without(self, axes) -> "PSpec":
        """The same placement with ``axes`` left whole."""
        return PSpec(tuple(tuple(a for a in d if a not in axes)
                           for d in self.dims))


def _shard_dims(spec, par: Par) -> list[tuple[int, tuple[str, ...]]]:
    """(dim, axes) of each sharded dimension of ``spec`` on ``par``."""
    if isinstance(spec, PSpec):
        return [(i, axes) for i, axes in enumerate(spec.dims) if axes]
    out = []
    if spec.tp_dim is not None and par.mp:
        out.append((spec.tp_dim, (par.mp,)))
    if spec.fsdp_dim is not None and spec.fsdp_axes:
        out.append((spec.fsdp_dim, spec.fsdp_axes))
    return out


def shard_index(spec, par: Par, shape=None) -> tuple[slice, ...]:
    """The index of this rank's shard in the logical tensor (of ``shape``,
    by default a WSpec's own)."""
    shape = spec.shape if shape is None else shape
    idx = [slice(None)] * len(shape)
    for dim, axes in _shard_dims(spec, par):
        step = shape[dim] // par.mesh.size_of(axes)
        i = par.mesh.index(axes)
        idx[dim] = slice(i * step, (i + 1) * step)
    return tuple(idx)


def local_slice(full, spec, par: Par):
    """This rank's shard of the logical tensor ``full`` (a view; a torch
    tensor or a numpy array)."""
    return full[shard_index(spec, par, full.shape)]


def gather_logical(local: torch.Tensor, spec, par: Par):
    """The logical tensor from every rank's shard ``local`` (collective:
    every rank of the mesh calls it, and every rank gets the whole
    tensor). No gradient."""
    out = local.detach()
    for dim, axes in _shard_dims(spec, par):
        out = comm.all_gather(out, dim, par.mesh.group(axes))
    return out
