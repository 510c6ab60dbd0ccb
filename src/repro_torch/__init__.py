"""PyTorch + CUDA port of the Firefly Monte Carlo package :mod:`repro`.

The JAX package stays the reference; this package runs the same single-device
FlyMC chain on an NVIDIA Hopper card through two hand-written CUDA kernels
(``kernels/bright_glm`` and ``kernels/z_update``). It imports ``torch`` and
``numpy`` only — never ``jax`` and never :mod:`repro`.

Every entry point takes an explicit ``device`` (default ``"cuda"``) and raises
when no card is present unless the caller asked for ``device="cpu"``; on the
CPU each kernel wrapper runs its plain PyTorch version.
"""

import torch

from repro_torch.device import resolve_device

# float32 throughout, as in the reference: no TF32 anywhere in the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]
