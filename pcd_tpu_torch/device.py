"""Device selection of the port's entry points: explicit, no backend probe."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None means the card.  Asking for a card that is not there raises:
    nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but none is "
                           "available (pass device='cpu' to run the plain "
                           "versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_card(device) -> bool:
    """Whether `device` is a card: the device tiers (the fixed-base keygen,
    Marlin's device transforms) run there only."""
    return device is not None and torch.device(device).type == "cuda"
