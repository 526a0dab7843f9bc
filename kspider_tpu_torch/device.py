"""Explicit device selection: the caller names the device, always."""

import torch


def resolve_device(name) -> torch.device:
    """``torch.device(name)``; raises when CUDA is asked for and absent, or
    when a CUDA index names a card the machine does not have.

    There is no fallback: a run that asked for the card and found none
    fails instead of quietly running on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False (no CUDA card or a CPU-only PyTorch build)"
        )
    if device.type == "cuda" and device.index is not None \
            and device.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {str(device)!r} requested but only "
            f"{torch.cuda.device_count()} CUDA card(s) are visible"
        )
    return device
