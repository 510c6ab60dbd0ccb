"""The port's default-device rule: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present. There is no silent fallback to the CPU: a caller that wants
    the CPU passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU"
            )
        if dev.index is None:  # "cuda" names the current card, as tensors do
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
