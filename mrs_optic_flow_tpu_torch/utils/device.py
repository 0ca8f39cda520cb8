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


def same_device(a, b) -> bool:
    """Whether ``a`` and ``b`` name the same device, a CUDA device without
    an index being the current one (``"cuda"`` and ``"cuda:0"`` are the
    same place on a host whose current card is 0)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)
