"""Host->device uploads that never block the host.

A copy from pageable host memory makes CUDA synchronise the stream first, so
a loop that uploads each batch that way cannot keep the next batch in flight
while the card works.  :class:`HostStaging` fills a pinned host buffer and
copies it with ``non_blocking=True``.  Each name has a ring of ``slots``
buffers; a slot is refilled only once the copy from it has finished (an
event recorded after the copy, waited on just before the refill), so a
pending copy is never overwritten.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch


class HostStaging:
    def __init__(self, device: torch.device, slots: int = 2):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.device = torch.device(device)
        self.slots = slots
        #: (name, slot) -> (pinned host tensor, event after its last copy or None)
        self._bufs: Dict[Tuple[str, int], list] = {}
        self._next: Dict[str, int] = {}

    def put(self, name: str, shape: tuple, dtype, fill: Callable[[np.ndarray], None]) -> torch.Tensor:
        """``fill(out)`` writes an array of ``shape`` and numpy ``dtype``
        into ``out``; the result is on the device, its copy queued on the
        current stream.  On a CPU device it is a new tensor over a new
        array."""
        shape, dtype = tuple(shape), np.dtype(dtype)
        if self.device.type != "cuda":
            out = np.empty(shape, dtype)
            fill(out)
            return torch.from_numpy(out)
        slot = self._next.get(name, 0)
        self._next[name] = (slot + 1) % self.slots
        entry = self._bufs.get((name, slot))
        if entry is not None and entry[1] is not None and not entry[1].query():
            entry[1].synchronize()  # the copy from this slot has left the buffer
        if entry is None or tuple(entry[0].shape) != shape or entry[0].numpy().dtype != dtype:
            host = torch.from_numpy(np.empty(0, dtype))
            entry = self._bufs[(name, slot)] = [
                torch.empty(shape, dtype=host.dtype, pin_memory=True), None]
        fill(entry[0].numpy())
        out = entry[0].to(self.device, non_blocking=True)
        entry[1] = torch.cuda.Event()
        entry[1].record(torch.cuda.current_stream(self.device))
        return out

    def array(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """:meth:`put` of a whole array."""
        arr = np.asarray(arr)
        return self.put(name, arr.shape, arr.dtype, lambda out: np.copyto(out, arr))
