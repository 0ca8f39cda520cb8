"""Host->device uploads that never block the host.

A copy from pageable host memory makes CUDA synchronise the stream first, so
a loop that uploads each batch that way cannot keep the next batch in flight
while the card works.  :class:`HostStaging` fills a pinned host buffer and
copies it with ``non_blocking=True``.  Each name has a ring of ``slots``
buffers; a slot is refilled only once the copy from it has finished (an
event recorded after the copy, waited on just before the refill), so a
pending copy is never overwritten.

One thread copies at a fraction of the host's memory bandwidth, and a fleet
tick or a serving batch is a hundred megabytes or more.  So a fill of
``PARALLEL_MIN_BYTES`` or more is split into ``POOL_WORKERS`` contiguous
ranges along axis 0 (streams or requests), written at once by one thread
pool shared by the whole process (NumPy releases the interpreter lock while
it copies); a smaller one, such as a tick's scalars, is filled on the
calling thread.  A fill returns once every range is written; the whole
array then crosses to the card in one copy (copying each range as soon as
it was written made a fleet tick's crops reach the card later,
``scripts/profile_staging_torch.py``).
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

#: ``fill(out, i, j)`` writes rows ``i:j`` (axis 0) of ``out``
Fill = Callable[[np.ndarray, int, int], None]

#: the shared pool's threads (``scripts/profile_staging_torch.py``)
POOL_WORKERS = min(8, len(os.sched_getaffinity(0)))
#: fills smaller than this stay on the calling thread: handing ranges to
#: the pool costs about 0.5 ms; one thread was faster up to 4 MiB, either
#: at 16 MiB, the pool from 32 MiB (``scripts/profile_staging_torch.py``)
PARALLEL_MIN_BYTES = 1 << 25

_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def shared_pool() -> concurrent.futures.ThreadPoolExecutor:
    """The process's staging threads, started at first use."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = concurrent.futures.ThreadPoolExecutor(POOL_WORKERS, thread_name_prefix="staging")
        return _pool


def fill_rows(out: np.ndarray, fill: Fill, parts: int,
              executor: Optional[concurrent.futures.Executor] = None) -> None:
    """``fill`` over ``parts`` contiguous ranges of ``out``'s axis 0 (at
    most one a row), each a task of ``executor``, or all of ``out`` on this
    thread for one part.  Returns once every range is written, raising the
    first range's error."""
    n = out.shape[0]
    parts = max(1, min(parts, n))
    if parts == 1:
        fill(out, 0, n)
        return
    edges = [n * k // parts for k in range(parts + 1)]
    futures = [executor.submit(fill, out, i, j) for i, j in zip(edges, edges[1:])]
    concurrent.futures.wait(futures)  # no range still writes when an error is raised
    for f in futures:
        f.result()


def fill_array(out: np.ndarray, fill: Fill) -> None:
    """``fill`` of all of ``out``: from the shared pool when ``out`` has
    ``PARALLEL_MIN_BYTES`` or more, else on this thread."""
    if out.nbytes < PARALLEL_MIN_BYTES:
        fill_rows(out, fill, 1)
    else:
        fill_rows(out, fill, POOL_WORKERS, shared_pool())


class HostStaging:
    def __init__(self, device: torch.device, slots: int = 2):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.device = torch.device(device)
        self.slots = slots
        #: (name, slot) -> (pinned host tensor, event after its last copy or None)
        self._bufs: Dict[Tuple[str, int], list] = {}
        self._next: Dict[str, int] = {}

    def put(self, name: str, shape: tuple, dtype, fill: Fill) -> torch.Tensor:
        """``fill(out, i, j)`` writes rows ``i:j`` of an array of
        ``shape`` and numpy ``dtype`` into ``out`` (see :func:`fill_array`: a
        large one is filled range by range from several threads at once);
        the result is on the device, its copy queued on the current stream.
        On a CPU device it is a new tensor over a new array."""
        shape, dtype = tuple(shape), np.dtype(dtype)
        if self.device.type != "cuda":
            out = np.empty(shape, dtype)
            fill_array(out, fill)
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
        fill_array(entry[0].numpy(), fill)
        out = entry[0].to(self.device, non_blocking=True)
        entry[1] = torch.cuda.Event()
        entry[1].record(torch.cuda.current_stream(self.device))
        return out

    def array(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """:meth:`put` of a whole array (a view, strided or not, is copied
        as it is: its values, C-contiguous)."""
        arr = np.asarray(arr)
        return self.put(name, arr.shape, arr.dtype, lambda out, i, j: np.copyto(out[i:j], arr[i:j]))
