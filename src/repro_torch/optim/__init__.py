"""Optimizer and schedule of the LM training step (see :mod:`repro.optim`)."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_update", "warmup_cosine"]
