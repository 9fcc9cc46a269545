"""Device selection of the frozen reference."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`torch.device(device)`, refusing a CUDA device when there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device "
                           "is available")
    return device
