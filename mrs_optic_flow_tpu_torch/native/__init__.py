"""ctypes binding to the repo's native host runtime (``native/src/of_runtime.cpp``):
the port's own copy of the capture-ring part of
:mod:`mrs_optic_flow_tpu.native` (the port imports nothing of the JAX
package).

- :class:`FrameQueue` -- lock-free SPSC ring buffer decoupling capture from
  the device feed;
- :func:`gather_latest` -- one native call that drains N rings to their
  newest frames (the fleet feeder's tick).

The library is built on first use with the repo Makefile (``make -C
native``: g++, plain C ABI).
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
_NATIVE_DIR = _REPO_ROOT / "native"
_LIB_PATH = _NATIVE_DIR / "libof_runtime.so"

_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True, capture_output=True, text=True)


def load() -> ctypes.CDLL:
    """Load (building if needed) the native runtime library."""
    global _lib
    if _lib is not None:
        return _lib
    src = _NATIVE_DIR / "src" / "of_runtime.cpp"
    if not _LIB_PATH.exists() or (src.exists() and src.stat().st_mtime > _LIB_PATH.stat().st_mtime):
        try:
            _build()
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise NativeUnavailable(f"cannot build native runtime: {e}") from e
    lib = ctypes.CDLL(str(_LIB_PATH))

    lib.ofq_create.restype = ctypes.c_void_p
    lib.ofq_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.ofq_destroy.argtypes = [ctypes.c_void_p]
    lib.ofq_push.restype = ctypes.c_int
    lib.ofq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_double]
    lib.ofq_pop.restype = ctypes.c_int
    lib.ofq_pop.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_double),
    ]
    lib.ofq_pop_latest.restype = ctypes.c_long
    lib.ofq_pop_latest.argtypes = lib.ofq_pop.argtypes
    lib.ofq_size.restype = ctypes.c_size_t
    lib.ofq_size.argtypes = [ctypes.c_void_p]
    lib.ofq_dropped.restype = ctypes.c_uint64
    lib.ofq_dropped.argtypes = [ctypes.c_void_p]
    lib.ofq_gather_latest.restype = ctypes.c_long
    lib.ofq_gather_latest.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_double), ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


class FrameQueue:
    """Lock-free SPSC frame queue (capture thread -> device-feed thread)."""

    def __init__(self, capacity: int, frame_shape: Tuple[int, ...], dtype=np.uint8):
        self._lib = load()
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.frame_bytes = int(np.prod(frame_shape)) * self.dtype.itemsize
        self._q = self._lib.ofq_create(capacity, self.frame_bytes)
        if not self._q:
            raise MemoryError("ofq_create failed")

    def push(self, frame: np.ndarray, stamp: float) -> bool:
        """True if enqueued; False if the queue was full (frame dropped)."""
        buf = np.ascontiguousarray(frame, self.dtype)
        if buf.nbytes != self.frame_bytes:
            raise ValueError(f"frame of shape {buf.shape}, queue takes {self.frame_shape}")
        return self._lib.ofq_push(self._q, buf.tobytes(), self.frame_bytes, stamp) == 0

    def pop(self) -> Optional[Tuple[np.ndarray, float]]:
        out = np.empty(self.frame_shape, self.dtype)
        stamp = ctypes.c_double()
        rc = self._lib.ofq_pop(
            self._q, out.ctypes.data_as(ctypes.c_void_p), self.frame_bytes, ctypes.byref(stamp),
        )
        if rc != 0:
            return None
        return out, stamp.value

    def pop_latest(self) -> Optional[Tuple[np.ndarray, float, int]]:
        """Newest frame, dropping older ones; returns (frame, stamp, skipped)."""
        out = np.empty(self.frame_shape, self.dtype)
        stamp = ctypes.c_double()
        rc = self._lib.ofq_pop_latest(
            self._q, out.ctypes.data_as(ctypes.c_void_p), self.frame_bytes, ctypes.byref(stamp),
        )
        if rc < 0:
            return None
        return out, stamp.value, int(rc)

    def __len__(self) -> int:
        return int(self._lib.ofq_size(self._q))

    @property
    def dropped(self) -> int:
        return int(self._lib.ofq_dropped(self._q))

    def __del__(self):
        if getattr(self, "_q", None):
            self._lib.ofq_destroy(self._q)
            self._q = None


def gather_latest(queues, batch: np.ndarray, stamps: np.ndarray, mask: np.ndarray) -> int:
    """Drain each queue to its newest frame into ``batch[i]``: one native
    call per fleet tick instead of N ctypes round trips.

    ``batch``: ``[N, ...]``, C-contiguous, any dtype (a raw byte copy; each
    queue's frame_bytes must match a batch slot); slots of empty queues are
    left as they are.  ``stamps``: float64 ``[N]``; ``mask``: uint8 ``[N]``,
    set to 1 where a frame was taken.  Returns the number of stale frames
    skipped.
    """
    lib = load()
    n = len(queues)
    if (not batch.flags.c_contiguous or batch.shape[0] != n or stamps.shape != (n,)
            or mask.shape != (n,) or stamps.dtype != np.float64 or mask.dtype != np.uint8
            or not (stamps.flags.c_contiguous and mask.flags.c_contiguous)):
        raise ValueError("gather_latest: batch [N, ...] C-contiguous, stamps float64 [N] and "
                         "mask uint8 [N]")
    frame_bytes = batch.nbytes // n
    handles = (ctypes.c_void_p * n)(*[q._q for q in queues])
    r = lib.ofq_gather_latest(
        handles, n, batch.ctypes.data_as(ctypes.c_void_p), frame_bytes,
        stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        mask.ctypes.data_as(ctypes.c_void_p),
    )
    if r < 0:
        raise ValueError("queue frame size does not match the batch")
    return int(r)
