"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  With no card and no explicit request this raises rather
    than carrying on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU (the kernels' plain PyTorch versions)")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but no CUDA "
                           "device is available")
    return dev
