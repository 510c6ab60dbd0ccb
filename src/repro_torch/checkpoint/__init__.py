"""Fault-tolerant checkpointing: atomic, durable, verified, restored onto a
device (port of :mod:`repro.checkpoint`)."""

from repro_torch.checkpoint.checkpointer import CheckpointCorruptError, Checkpointer

__all__ = ["CheckpointCorruptError", "Checkpointer"]
