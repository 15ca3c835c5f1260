"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """A CUDA device without a GPU raises: the CPU is used only when the
    caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available. The port runs on a CUDA device; pass "
            "device='cpu' explicitly for the plain CPU path (tests, smoke runs)."
        )
    return dev
