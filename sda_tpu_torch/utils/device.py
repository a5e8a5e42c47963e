"""The port's device rule: entry points run on the card unless the caller
names another device."""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: nothing
    drops to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device
