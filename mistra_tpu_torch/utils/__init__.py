"""Numerical utilities of the PyTorch port."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device on a host without one raises
    at once: the port's entry points never fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           "available; pass device=\"cpu\" to run on the "
                           "CPU")
    return dev
