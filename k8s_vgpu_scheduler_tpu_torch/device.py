"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when the card is asked for and there is none —
    no path quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev
