"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names another device. Raises when CUDA is
    asked for (or defaulted to) and absent — there is no silent fallback
    to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' explicitly to "
                "run on the plain torch versions")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but CUDA is not available")
    return dev
