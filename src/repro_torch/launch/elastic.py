"""Elastic mesh and chain-slot planning, and straggler detection.

Port of :mod:`repro.launch.elastic`: :func:`plan_mesh` (the LM stack's
mesh after device loss), :func:`plan_chain_slots` and
:class:`StragglerMonitor`, which the sampling service uses. The
checkpointer stores logical (unsharded) arrays, so a sharded run restores
onto the planned mesh (``Checkpointer.restore(shardings=, mesh=)``). The
controller loop is the reference's:

    while True:
        n = surviving ranks
        plan = plan_mesh(n)
        mesh = make_mesh(plan.shape, plan.axis_names)
        state = ckpt.restore(target, shardings=specs_for(mesh), mesh=mesh)
        run_until_failure(mesh, state, ckpt)

Data-sharded FlyMC needs no mesh: :mod:`repro_torch.distributed.flymc_dist`
shards over a ``torch.distributed`` process group.
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import Mesh


def plan_mesh(n_devices: int, model_parallel: int = 16) -> Mesh:
    """Largest (pod, data, model) layout with full model-parallel groups
    over ``n_devices`` ranks (the first ``groups · model_parallel``).

    Keeps ``model`` fixed (the TP degree is a property of the checkpointed
    layout) and absorbs device loss into the data axes, the elastic
    dimension; from 32 groups on, a multiple of 16, the data axis splits
    into pods of 16. Returns a layout (no process groups)."""
    groups = n_devices // model_parallel
    if groups < 1:
        raise ValueError(
            f"{n_devices} devices cannot host model_parallel={model_parallel}"
        )
    if groups >= 32 and groups % 16 == 0:
        return Mesh(("pod", "data", "model"),
                    (groups // 16, 16, model_parallel))
    return Mesh(("data", "model"), (groups, model_parallel))


def plan_chain_slots(n_devices: int, slots_per_device: int = 8) -> int:
    """The sampling service's chain-slot budget for ``n_devices`` devices.

    Chains need no cross-chain communication, so device loss turns linearly
    into slot loss. ``n_devices=0`` is legal (total loss: the service
    suspends every job and waits); only a negative count is an error.
    """
    if n_devices < 0:
        raise ValueError(f"device count cannot be negative, got {n_devices}")
    return n_devices * slots_per_device


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags hosts slower than median × threshold."""

    alpha: float = 0.2
    threshold: float = 1.5
    ewma: dict = dataclasses.field(default_factory=dict)

    def record(self, host: str, step_seconds: float):
        prev = self.ewma.get(host)
        self.ewma[host] = (
            step_seconds
            if prev is None
            else (1 - self.alpha) * prev + self.alpha * step_seconds
        )

    def stragglers(self) -> list[str]:
        if len(self.ewma) < 2:
            return []
        times = sorted(self.ewma.values())
        median = times[len(times) // 2]
        return [h for h, t in self.ewma.items() if t > self.threshold * median]
