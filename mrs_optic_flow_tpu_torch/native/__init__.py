"""ctypes binding to the repo's native host runtime (``native/src/of_runtime.cpp``):
the port's own copy of :mod:`mrs_optic_flow_tpu.native` (the port imports
nothing of the JAX package).

- :class:`FrameQueue` -- lock-free SPSC ring buffer decoupling capture from
  the device feed;
- :func:`gather_latest` -- one native call that drains N rings to their
  newest frames (the fleet feeder's tick);
- :func:`bgr_to_gray`, :func:`crop` and :func:`gray_crop` -- fixed-point
  uint8 preprocessing on the host (``src/optic_flow.cpp:1602-1622``), fused
  so only the cropped window is converted; :func:`crop` and
  :func:`gray_crop` count their calls in ``<function>.CALLS``;
- :class:`Recorder` and :class:`Replay` -- the timestamped raw-frame log
  (``.ofrec``), writer and indexed reader.

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

    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.ofp_bgr_to_gray.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int]
    lib.ofp_crop.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
    lib.ofp_gray_crop.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
    ]

    lib.ofr_open_write.restype = ctypes.c_void_p
    lib.ofr_open_write.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ofr_write.restype = ctypes.c_int
    lib.ofr_write.argtypes = [ctypes.c_void_p, ctypes.c_double, u8p]
    lib.ofr_open_read.restype = ctypes.c_void_p
    lib.ofr_open_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
    ]
    lib.ofr_read.restype = ctypes.c_int
    lib.ofr_read.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_double), u8p]
    lib.ofr_close.argtypes = [ctypes.c_void_p]
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


def bgr_to_gray(img: np.ndarray, swap_rb: bool = True) -> np.ndarray:
    """Fixed-point uint8 grayscale (OpenCV weights; ``swap_rb`` reproduces
    the reference's CV_RGB2GRAY-on-BGR behaviour, ``src/optic_flow.cpp:1622``)."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    out = np.empty((h, w), np.uint8)
    lib.ofp_bgr_to_gray(img, h, w, out, int(swap_rb))
    return out


def _check_crop(size: int, h: int, w: int) -> None:
    # the C side clamps origins into bounds but cannot satisfy a window
    # larger than the image: reject it here instead of reading garbage
    if size > w or size > h:
        raise ValueError(f"crop size {size} exceeds image {w}x{h}")


def crop(img: np.ndarray, cx: int, cy: int, size: int) -> np.ndarray:
    """The ``size``² window of a uint8 gray image centred at (cx, cy)."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    _check_crop(size, h, w)
    out = np.empty((size, size), np.uint8)
    lib.ofp_crop(img, h, w, cx, cy, size, out)
    crop.CALLS += 1
    return out


def gray_crop(img: np.ndarray, cx: int, cy: int, size: int, swap_rb: bool = True) -> np.ndarray:
    """Fused grayscale + crop of a uint8 BGR image: converts only the
    cropped window."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    _check_crop(size, h, w)
    out = np.empty((size, size), np.uint8)
    lib.ofp_gray_crop(img, h, w, cx, cy, size, int(swap_rb), out)
    gray_crop.CALLS += 1
    return out


crop.CALLS = 0
gray_crop.CALLS = 0


class Recorder:
    """Timestamped raw-frame stream log (write mode)."""

    def __init__(self, path: str, width: int, height: int, channels: int = 1):
        self._lib = load()
        self._r = self._lib.ofr_open_write(path.encode(), width, height, channels)
        if not self._r:
            raise OSError(f"cannot open {path} for writing")
        self.frame_shape = (height, width) if channels == 1 else (height, width, channels)

    def write(self, stamp: float, frame: np.ndarray):
        buf = np.ascontiguousarray(frame, np.uint8)
        if buf.shape != self.frame_shape:
            raise ValueError(f"frame of shape {buf.shape}, the recording takes {self.frame_shape}")
        if self._lib.ofr_write(self._r, stamp, buf) != 0:
            raise OSError("recorder write failed")

    def close(self):
        if self._r:
            self._lib.ofr_close(self._r)
            self._r = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Replay:
    """Indexed reader for :class:`Recorder` logs."""

    def __init__(self, path: str):
        self._lib = load()
        w, h, ch, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
        self._r = self._lib.ofr_open_read(
            path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch), ctypes.byref(n)
        )
        if not self._r:
            raise OSError(f"cannot open {path} (missing or bad magic)")
        self.width, self.height, self.channels = w.value, h.value, ch.value
        self.n_frames = n.value
        self.frame_shape = (
            (self.height, self.width) if self.channels == 1
            else (self.height, self.width, self.channels)
        )

    def read(self, idx: int) -> Tuple[float, np.ndarray]:
        out = np.empty(self.frame_shape, np.uint8)
        stamp = ctypes.c_double()
        if self._lib.ofr_read(self._r, idx, ctypes.byref(stamp), out) != 0:
            raise IndexError(idx)
        return stamp.value, out

    def __iter__(self):
        for i in range(self.n_frames):
            yield self.read(i)

    def close(self):
        if self._r:
            self._lib.ofr_close(self._r)
            self._r = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
