"""The LM stack's device mesh over the ranks of a ``torch.distributed``
group: axis names, shape, this rank's coordinates and one process group
per set of axes that a collective reduces or gathers over.

Port of :mod:`repro.launch.mesh`. The reference's mesh is a grid of JAX
devices; here it is a grid of ranks, one process each, numbered row-major
over the axes (rank = Σ coordinate · stride; the last axis, ``model``,
fastest), as ``jax.make_mesh`` lays devices out. The production shapes
are the reference's: (data=16, model=16) for one pod, (pod=2, data=16,
model=16) for two; the ``pod`` axis carries only FSDP/DP traffic.

:func:`make_mesh` builds the groups: for every non-empty set of axes, the
ranks that differ only along those axes form one group (every rank builds
every ``new_group`` in the same order, as ``torch.distributed`` requires).
A :class:`Mesh` made without them (:func:`make_production_mesh`,
:func:`repro_torch.launch.elastic.plan_mesh`) is a layout: it has shapes
and names but no groups; :func:`make_mesh` of its shape and names builds
them.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import torch.distributed as dist

from repro_torch.distributed.par import Par


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (pod, data, model)-style grid of ranks. ``rank`` is this process's
    rank in the default group (None for a layout); ``groups`` maps each
    sorted tuple of axis names to this rank's process group over them."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int | None = None
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate along each axis (row-major)."""
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.shape))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def _ordered(self, axes) -> tuple[str, ...]:
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise KeyError(f"axes {sorted(unknown)} not in mesh "
                           f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def size_of(self, axes) -> int:
        return math.prod(self.sizes[a] for a in self._ordered(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (in mesh order): its
        position in the group over them, and the shard of a dimension
        split over them that it holds."""
        c = self.coords
        i = 0
        for a in self._ordered(axes):
            i = i * self.sizes[a] + c[a]
        return i

    def group(self, axes):
        """This rank's process group over ``axes``."""
        if self.rank is None:
            raise RuntimeError("a mesh layout has no process groups: build "
                               "it with make_mesh(shape, axis_names)")
        return self.groups[self._ordered(axes)]


def make_mesh(shape, axis_names) -> Mesh:
    """The mesh of ``shape`` over ranks ``0 .. prod(shape) - 1`` of the
    default group, with its process groups (collective: every rank of the
    default group calls it; a rank past the mesh gets ``rank=None``)."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    size = math.prod(shape)
    world = dist.get_world_size()
    if world < size:
        raise ValueError(f"a {shape} mesh needs {size} ranks; the group has "
                         f"{world}")
    me = dist.get_rank()
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    groups = {}
    for k in range(1, len(shape) + 1):
        for axes in itertools.combinations(range(len(shape)), k):
            rest = [i for i in range(len(shape)) if i not in axes]
            for fixed in itertools.product(*(range(shape[i]) for i in rest)):
                base = sum(c * strides[i] for c, i in zip(fixed, rest))
                ranks = [base + sum(c * strides[i] for c, i in zip(v, axes))
                         for v in itertools.product(*(range(shape[i])
                                                      for i in axes))]
                g = dist.new_group(ranks)
                if me in ranks:
                    groups[tuple(axis_names[i] for i in axes)] = g
    return Mesh(axis_names, shape, me if me < size else None, groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout (no process groups)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def mesh_axis_sizes(mesh: Mesh) -> dict[str, int]:
    return mesh.sizes


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_par(mesh: Mesh) -> Par:
    """The axis context of ``mesh``: dp = its (pod, data) axes, mp =
    ``model``, their sizes, and the mesh's process groups."""
    sizes = mesh.sizes
    dp = data_axes(mesh)
    return Par(dp=dp, mp="model" if "model" in sizes else None,
               dp_size=math.prod(sizes[a] for a in dp) if dp else 1,
               mp_size=sizes.get("model", 1), mesh=mesh)
