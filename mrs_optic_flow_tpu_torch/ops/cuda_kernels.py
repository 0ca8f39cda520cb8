"""Hand-written CUDA kernels and their plain PyTorch twins.

Counterpart of :mod:`mrs_optic_flow_tpu.ops.pallas_kernels`.  Kernel A of
the port, :func:`phase_correlate_frames`, replaces
``pallas_kernels.py::phase_correlate_frames_pallas``: whole ``[B, H, W]``
frame pairs in, one ``(shift, maxval)`` per patch of the ``q x q`` grid out.
Its source is ``csrc/phase_correlate_frames.cu``, compiled with ``nvcc`` for
``sm_90a`` into ``build/torch_kernels/`` at first use and bound with ctypes.

Dispatch is by the device of the tensors: CPU tensors take the plain twin
:func:`phase_correlate_frames_ref`; CUDA tensors launch the kernel or raise.
Nothing falls back from the kernel to the twin.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import subprocess
from typing import Tuple

import numpy as np
import torch

from mrs_optic_flow_tpu_torch.ops.phase_correlate import (
    DEFAULT_CENTROID_RADIUS,
    DEFAULT_SEARCH_RADIUS,
    _dft_matrices,
    correlation_surface,
    peak_refine,
)
from mrs_optic_flow_tpu_torch.ops.preprocess import patchify

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "phase_correlate_frames.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libphase_correlate_frames.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    # PyTorch's own search: $CUDA_HOME, then nvcc on PATH, then the default prefix
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> str:
    """Compile the kernel library from the sources in the package with
    ``nvcc``; returns the compiler's log (``-Xptxas=-v``: registers, shared
    memory and spills per kernel).  Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library, built first when missing or older than its source."""
    if not LIBRARY.exists() or SOURCE.stat().st_mtime > LIBRARY.stat().st_mtime:
        build()
    lib = ctypes.CDLL(str(LIBRARY))
    lib.pcf_smem_bytes.restype = ctypes.c_longlong
    lib.pcf_smem_bytes.argtypes = [ctypes.c_int]
    lib.pcf_phase_correlate_frames.restype = ctypes.c_int
    lib.pcf_phase_correlate_frames.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # curr, prev, is_u8
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # batch, height, width
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, q, radii
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # tab, shift, maxval
        ctypes.c_void_p,  # stream
    ]
    return lib


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """``[n, 2]`` float32 table ``(cos, sin)(-2 pi m / n)``: row 1 of
    :func:`_dft_matrices` (built in float64, cast to float32).  The kernel
    reads entry ``(j, k)`` of the DFT matrix as ``m = j*k mod n``; the
    reduced angle differs from the float64 matrix entry by at most 1.2e-13
    absolute for n <= 136."""
    c, s = _dft_matrices(n)
    tab = np.ascontiguousarray(np.stack([c[1], s[1]], axis=-1))
    return torch.from_numpy(tab).to(device)


def _grid(shape, patch: int) -> int:
    """Side ``q`` of the square patch grid of ``[..., H, W]`` frames."""
    h, w = shape[-2:]
    if h != w or w % patch:
        raise ValueError(f"frames {h}x{w} are not a square grid of {patch} px patches")
    return w // patch


def phase_correlate_frames_ref(
    curr: torch.Tensor,
    prev: torch.Tensor,
    *,
    patch: int,
    search_radius: int = DEFAULT_SEARCH_RADIUS,
    centroid_radius: int = DEFAULT_CENTROID_RADIUS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: patchify, then the ``dft``
    correlation surface and the peak refine of
    :mod:`~mrs_optic_flow_tpu_torch.ops.phase_correlate`.  Same contract as
    :func:`phase_correlate_frames`."""
    _grid(curr.shape, patch)
    surf = correlation_surface(
        patchify(curr, patch), patchify(prev, patch),
        search_radius=search_radius, backend="dft",
    )
    return peak_refine(surf, centroid_radius=centroid_radius)


def phase_correlate_frames(
    curr: torch.Tensor,
    prev: torch.Tensor,
    *,
    patch: int,
    search_radius: int = DEFAULT_SEARCH_RADIUS,
    centroid_radius: int = DEFAULT_CENTROID_RADIUS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A: ``[B, H, W]`` frame pairs (uint8 or float32, H = W =
    q * patch) -> ``(shift [B, q*q, 2], maxval [B, q*q])`` in field order
    ``i + q*j``.

    CPU tensors run :func:`phase_correlate_frames_ref`.  CUDA tensors launch
    ``csrc/phase_correlate_frames.cu`` on the current stream; each launch
    adds one to ``phase_correlate_frames.LAUNCHES``.
    """
    if curr.device.type == "cpu" and prev.device.type == "cpu":
        return phase_correlate_frames_ref(
            curr, prev, patch=patch, search_radius=search_radius,
            centroid_radius=centroid_radius,
        )
    if curr.device.type != "cuda" or prev.device != curr.device:
        raise ValueError(f"expected both frames on one CUDA device, got {curr.device} and {prev.device}")
    if curr.dtype not in (torch.uint8, torch.float32) or prev.dtype != curr.dtype:
        raise ValueError(f"expected uint8 or float32 frames of one dtype, got {curr.dtype} and {prev.dtype}")
    if curr.ndim != 3 or prev.shape != curr.shape:
        raise ValueError(f"expected two [B, H, W] batches, got {tuple(curr.shape)} and {tuple(prev.shape)}")
    if not (curr.is_contiguous() and prev.is_contiguous()):
        raise ValueError("frames must be contiguous")
    if search_radius < 0 or centroid_radius < 0:
        raise ValueError("radii must be non-negative")
    b, h, w = curr.shape
    q = _grid(curr.shape, patch)
    lib = load_library()
    smem = lib.pcf_smem_bytes(patch)
    limit = torch.cuda.get_device_properties(curr.device).shared_memory_per_block_optin
    if smem + 1024 > limit:  # 1 KiB for the kernel's static shared memory
        raise ValueError(f"patch {patch} needs {smem} B of shared memory; the device allows {limit}")

    shift = torch.empty((b, q * q, 2), dtype=torch.float32, device=curr.device)
    maxval = torch.empty((b, q * q), dtype=torch.float32, device=curr.device)
    tab = _twiddles(patch, curr.device)
    with torch.cuda.device(curr.device):
        err = lib.pcf_phase_correlate_frames(
            curr.data_ptr(), prev.data_ptr(), int(curr.dtype == torch.uint8),
            b, h, w, patch, q, search_radius, centroid_radius,
            tab.data_ptr(), shift.data_ptr(), maxval.data_ptr(),
            torch.cuda.current_stream(curr.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"phase_correlate_frames launch failed: CUDA error {err}")
    phase_correlate_frames.LAUNCHES += 1
    return shift, maxval


phase_correlate_frames.LAUNCHES = 0
