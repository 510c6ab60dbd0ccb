"""Elastic chain-slot planning and straggler detection.

Port of :mod:`repro.launch.elastic`'s :func:`plan_chain_slots` and
:class:`StragglerMonitor`, which the sampling service uses. ``plan_mesh``
builds a device mesh for the LM stack's tensor-parallel and FSDP paths; it
waits for them (ROADMAP queue 1, item 9f) and raises until then. Data-sharded
FlyMC needs no mesh: :mod:`repro_torch.distributed.flymc_dist` shards over a
``torch.distributed`` process group.
"""

from __future__ import annotations

import dataclasses


def plan_mesh(n_devices: int, model_parallel: int = 16):
    """Not ported: the reference builds a JAX mesh here."""
    raise NotImplementedError(
        "plan_mesh builds the LM stack's tensor-parallel and FSDP mesh "
        f"(model_parallel={model_parallel}); it comes with tensor-parallel "
        "serving on torch.distributed (ROADMAP queue 1, item 9f)"
    )


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
