"""The device an entry point runs on."""

from __future__ import annotations

import torch

#: where every entry point runs unless the caller names another device
DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device`.  A CUDA device that this host
    does not have raises: the entry points run on the card unless the
    caller passes ``device="cpu"``, and never fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r}: no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
