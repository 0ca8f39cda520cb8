"""Hand-written CUDA kernels and their plain PyTorch twins.

Counterpart of :mod:`mrs_optic_flow_tpu.ops.pallas_kernels` and of the
Pallas SAD kernel in :mod:`mrs_optic_flow_tpu.ops.block_matching`:

- kernel A, :func:`phase_correlate_frames`, replaces
  ``pallas_kernels.py::phase_correlate_frames_pallas``: whole ``[B, H, W]``
  frame pairs in, one ``(shift, maxval)`` per patch of the ``q x q`` grid
  out (``csrc/phase_correlate_frames.cu``);
- kernel B, :func:`peak_refine_raw`, replaces
  ``pallas_kernels.py::peak_refine_raw_pallas``: fftshift, mask, argmax and
  centroid of raw correlation surfaces (``csrc/peak_refine_raw.cu``);
- kernel C, :func:`sad_search`, replaces
  ``block_matching.py::sad_search_pallas``: the exhaustive block-matching
  SAD map of each grid cell (``csrc/sad_search.cu``);
- kernel D, :func:`phase_correlate_fullfused`, replaces
  ``pallas_kernels.py::phase_correlate_fullfused_pallas``: ``[P, N, N]``
  patch pairs of any size in, one ``(shift, maxval)`` per pair out, a
  mixed-radix FFT in one block a pair up to N = 170 and in four staged
  launches beyond (``csrc/phase_correlate_fullfused.cu``);
- kernel E, :func:`phase_correlate_fused`, replaces
  ``pallas_kernels.py::phase_correlate_fused_pallas``: the cross-power, full
  complex inverse FFT and peak of forward spectra that the wrapper computes
  with two float32 matrix products (``csrc/phase_correlate_fused.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a library of its own
under ``build/torch_kernels/`` at first use, and is bound with ctypes.  The
headers in ``csrc/`` hold device code that several sources share: the peak
stage of kernel B (``peak_refine.cuh``, in B, D and E) and the mixed-radix
FFT stages with their route rule (``fft_stages.cuh``, in D and E).

Dispatch is by the device of the tensors: CPU tensors take the plain twin;
CUDA tensors launch the kernel or raise.  Nothing falls back from a kernel to
its twin.  Each wrapper counts its launches in ``<wrapper>.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import subprocess
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mrs_optic_flow_tpu_torch.ops import block_matching
from mrs_optic_flow_tpu_torch.ops.phase_correlate import (
    DEFAULT_CENTROID_RADIUS,
    DEFAULT_SEARCH_RADIUS,
    _dft_matrices,
    correlation_surface,
    peak_refine,
    shift_and_mask,
)
from mrs_optic_flow_tpu_torch.ops.preprocess import patchify
from mrs_optic_flow_tpu_torch.utils.precision import pinned

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
#: kernel name -> its source in ``csrc/``; each builds into ``lib<name>.so``
SOURCES = {
    "phase_correlate_frames": "phase_correlate_frames.cu",
    "peak_refine_raw": "peak_refine_raw.cu",
    "sad_search": "sad_search.cu",
    "phase_correlate_fullfused": "phase_correlate_fullfused.cu",
    "phase_correlate_fused": "phase_correlate_fused.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: kernel name -> {C function: (restype, argtypes)}
_SIGNATURES = {
    "phase_correlate_frames": {
        "pcf_smem_bytes": (_LL, [_I]),
        "pcf_blocks_per_sm": (_I, [_I]),
        # curr, prev, is_u8, batch, height, width, n, q, radii, tab, shift,
        # maxval, stream
        "pcf_phase_correlate_frames": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                            _P, _P, _P, _P]),
    },
    "peak_refine_raw": {
        # surf, p, n, radii, k, band_rows, vec, scratch, counters, shift,
        # maxval, index, stream
        "prr_peak_refine_split": (_I, [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]),
    },
    "sad_search": {
        "sad_smem_bytes": (_LL, [_I, _I]),
        "sad_scratch_doubles": (_LL, [_I, _I, _I, _I]),
        "sad_counters": (_LL, [_I, _I, _I, _I]),
        # curr, prev, g, s, r, xb, scratch, counters, out, stream
        "sad_search_tiled": (_I, [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P]),
    },
    "phase_correlate_fullfused": {
        "pcff_route": (_I, [_I]),
        "pcff_plan": (_I, [_I, _P]),
        "pcff_smem_bytes": (_LL, [_I]),
        "pcff_scratch_bytes": (_LL, [_I]),
        # curr, prev, is_u8, p, n, chunk, radii, peak k, band_rows, tab,
        # scratch, shift, maxval, stream
        "pcff_phase_correlate_fullfused": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                                _P, _P, _P, _P, _P]),
    },
    "phase_correlate_fused": {
        "pcfu_smem_bytes": (_LL, [_I]),
        "pcfu_scratch_bytes": (_LL, [_I]),
        # curr, prev, is_u8, p, n, out, stream
        "pcfu_stack": (_I, [_P, _P, _I, _I, _I, _P, _P]),
        # spec, p, n, chunk, radii, peak k, band_rows, tab, scratch, shift,
        # maxval, stream
        "pcfu_phase_correlate_fused": (_I, [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    },
}


def _nvcc() -> str:
    # PyTorch's own search: $CUDA_HOME, then nvcc on PATH, then the default prefix
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the kernel libraries ``names`` (default: all) from the
    sources in the package, one ``nvcc`` process per source, all started
    together.  Returns each kernel's compiler log (``-Xptxas=-v``:
    registers, shared memory and spills).  Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names or SOURCES:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp)
    logs, failed = {}, []
    for name, (proc, tmp) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            failed.append(f"{SOURCES[name]}: nvcc failed ({proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s library, built first when missing or older than its
    source or a shared header."""
    lib_path = library_path(name)
    newest = max(p.stat().st_mtime for p in [CSRC / SOURCES[name], *CSRC.glob("*.cuh")])
    if not lib_path.exists() or newest > lib_path.stat().st_mtime:
        build([name])
    lib = ctypes.CDLL(str(lib_path))
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _check_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Every tensor contiguous and on the first one's CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: expected tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")


#: bytes of static shared memory a kernel may add to its dynamic request
STATIC_SMEM_BYTES = 1024


@functools.lru_cache(maxsize=None)
def _smem_limit(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def _smem_fits(smem: int, device: torch.device, what: str) -> None:
    limit = _smem_limit(device)
    if smem + STATIC_SMEM_BYTES > limit:
        raise ValueError(f"{what} needs {smem} B of shared memory; the device allows {limit}")


#: kernel, device, stream -> the int32 counters of its last-block merge
_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _counters(name: str, device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed counters for kernel ``name``'s last-block merge
    on the current stream of ``device``: one buffer a (kernel, device,
    stream), grown on demand.  Every launch leaves its counters zero again,
    so calls on one stream share it; calls on two streams never do."""
    key = (name, device, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return buf


# --------------------------------------------------------------------------- #
# kernel A: whole-frame phase correlation                                      #
# --------------------------------------------------------------------------- #


#: shared memory of one block of an H100 (and H200) with the opt-in attribute
H100_SMEM_OPTIN_BYTES = 232_448


def pcf_smem_bytes(n: int) -> int:
    """Kernel A's dynamic shared memory for patch ``n``: one ``n x n``
    complex float32 buffer, as ``pcf_smem_bytes`` in
    ``csrc/phase_correlate_frames.cu`` computes it (115,200 B at n = 120,
    so two blocks share an SM)."""
    return n * n * 8


#: the largest patch whose buffer fits a block of an H100: 170 (231,200 B);
#: with the multiple-of-8 rule, 168 (the kernel's largest, m = 21)
PCF_MAX_PATCH = max(
    n for n in range(1, 1024) if pcf_smem_bytes(n) + STATIC_SMEM_BYTES <= H100_SMEM_OPTIN_BYTES
)


def frames_kernel_takes(patch: int) -> bool:
    """The route rule of the engines: kernel A for a patch that is a
    multiple of 8 (the JAX engine's rule for its frames kernel, and the
    radix-8 step of A's FFT) and within A's shared memory; kernel D for
    every other patch.  A constant, so that the CPU and the card route
    alike."""
    return patch % 8 == 0 and patch <= PCF_MAX_PATCH


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """``[n, 2]`` float32 table ``(cos, sin)(-2 pi m / n)``: row 1 of
    :func:`_dft_matrices` (built in float64, cast to float32).  Kernel E
    reads entry ``(j, k)`` of the DFT matrix as ``m = j*k mod n``; the
    reduced angle differs from the float64 matrix entry by at most 1.2e-13
    absolute for n <= 136 and 5.9e-13 for n <= 480 (the float32 tables by
    at most 5.1e-13).  Kernel A's FFT reads the twiddle ``W_n^(j1 k2)`` at
    ``j1 * k2 < n`` and ``W_m^(j1 k1)`` at ``8 * (j1 k1 mod m)``; kernel D's
    stage of radix r and span L reads ``W_L^(j k)`` at ``j k n / L`` and
    ``W_r^(q k)`` at ``(q k mod r) n / r``."""
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
    """Plain PyTorch twin of kernel A: patchify, then the ``dft``
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
    ``csrc/phase_correlate_frames.cu`` on the current stream, one block a
    window, for a patch that :func:`frames_kernel_takes`; each launch adds
    one to ``phase_correlate_frames.LAUNCHES``.
    """
    if curr.device.type == "cpu" and prev.device.type == "cpu":
        return phase_correlate_frames_ref(
            curr, prev, patch=patch, search_radius=search_radius,
            centroid_radius=centroid_radius,
        )
    _check_cuda("phase_correlate_frames", curr, prev)
    if curr.dtype not in (torch.uint8, torch.float32) or prev.dtype != curr.dtype:
        raise ValueError(f"expected uint8 or float32 frames of one dtype, got {curr.dtype} and {prev.dtype}")
    if curr.ndim != 3 or prev.shape != curr.shape:
        raise ValueError(f"expected two [B, H, W] batches, got {tuple(curr.shape)} and {tuple(prev.shape)}")
    if search_radius < 0 or centroid_radius < 0:
        raise ValueError("radii must be non-negative")
    if not frames_kernel_takes(patch):
        raise ValueError(f"kernel A takes patches that are multiples of 8 up to {PCF_MAX_PATCH}, "
                         f"not {patch}")
    b, h, w = curr.shape
    q = _grid(curr.shape, patch)
    # the kernel reads 4 pixels at a time: 16-byte aligned frames
    curr, prev = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (curr, prev))
    lib = load_library("phase_correlate_frames")
    _smem_fits(lib.pcf_smem_bytes(patch), curr.device, f"patch {patch}")

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
    _check_launch(err, "phase_correlate_frames")
    phase_correlate_frames.LAUNCHES += 1
    return shift, maxval


phase_correlate_frames.LAUNCHES = 0


# --------------------------------------------------------------------------- #
# kernel B: peak refine of raw correlation surfaces                            #
# --------------------------------------------------------------------------- #


def peak_refine_raw_ref(
    raw: torch.Tensor,
    *,
    search_radius: int = DEFAULT_SEARCH_RADIUS,
    centroid_radius: int = DEFAULT_CENTROID_RADIUS,
    with_index: bool = False,
):
    """Plain PyTorch twin of kernel B: the fftshift and search-window mask
    of :func:`~mrs_optic_flow_tpu_torch.ops.phase_correlate.shift_and_mask`,
    then :func:`~mrs_optic_flow_tpu_torch.ops.phase_correlate.peak_refine`.
    Same contract as :func:`peak_refine_raw`."""
    surf = shift_and_mask(raw.to(torch.float32), search_radius)
    shift, maxval = peak_refine(surf, centroid_radius=centroid_radius)
    if not with_index:
        return shift, maxval
    n = raw.shape[-1]
    return shift, maxval, torch.argmax(surf.reshape(surf.shape[:-2] + (n * n,)), dim=-1)


#: blocks the split peak aims at (kernel B, and kernel D's staged design):
#: two on each of an H100's 132 SMs
PEAK_FILL_BLOCKS = 264


def peak_window_rows(n: int, search_radius: int) -> int:
    """Rows (and columns) of an ``n x n`` surface inside the search window:
    ``2 r + 1`` while ``n // 2 > r``, else all ``n``."""
    return 2 * search_radius + 1 if n // 2 > search_radius else n


def peak_split(p: int, n: int, search_radius: int) -> Tuple[int, int]:
    """Kernel B's blocks a surface and window rows a block, ``(k,
    band_rows)``: the fewest rows a block with which ``p * k`` reaches
    ``PEAK_FILL_BLOCKS`` (k = 1 once ``p`` does), ``k * band_rows`` covering
    the window's rows.  240 blocks of 2 rows at ``p = 1, n = 480, r = 240``."""
    rows = peak_window_rows(n, search_radius)
    k = max(1, min(rows, -(-PEAK_FILL_BLOCKS // max(p, 1))))
    band_rows = -(-rows // k)
    return -(-rows // band_rows), band_rows


def peak_refine_raw(
    raw: torch.Tensor,
    *,
    search_radius: int = DEFAULT_SEARCH_RADIUS,
    centroid_radius: int = DEFAULT_CENTROID_RADIUS,
    with_index: bool = False,
):
    """Kernel B: ``[..., N, N]`` raw (unshifted) float32 correlation
    surfaces -> ``(shift [..., 2], maxval [...])``, shift relative to the
    centre ``(N//2, N//2)`` in (x, y) order.  ``with_index`` adds the peak's
    fftshifted flat index ``[...]`` (undefined where maxval is NaN).

    CPU tensors run :func:`peak_refine_raw_ref`.  CUDA tensors launch
    ``csrc/peak_refine_raw.cu`` on the current stream, each surface split
    over the blocks :func:`peak_split` names; each launch adds one to
    ``peak_refine_raw.LAUNCHES``.
    """
    if raw.device.type == "cpu":
        return peak_refine_raw_ref(
            raw, search_radius=search_radius, centroid_radius=centroid_radius,
            with_index=with_index,
        )
    _check_cuda("peak_refine_raw", raw)
    n = raw.shape[-1]
    if raw.dtype != torch.float32 or raw.ndim < 2 or raw.shape[-2] != n:
        raise ValueError(f"expected [..., N, N] float32 surfaces, got {raw.dtype} {tuple(raw.shape)}")
    if search_radius < 0 or centroid_radius < 0:
        raise ValueError("radii must be non-negative")
    lead = tuple(raw.shape[:-2])
    p = int(np.prod(lead, dtype=np.int64))
    shift = torch.empty(lead + (2,), dtype=torch.float32, device=raw.device)
    maxval = torch.empty(lead, dtype=torch.float32, device=raw.device)
    index = torch.empty(lead, dtype=torch.int32, device=raw.device) if with_index else None
    if p and n:
        lib = load_library("peak_refine_raw")
        k, band_rows = peak_split(p, n, search_radius)
        vec = int(n % 4 == 0 and raw.data_ptr() % 16 == 0)
        scratch = torch.empty((3 * p * k,), dtype=torch.int32, device=raw.device)
        counters = _counters("peak_refine_raw", raw.device, p)
        with torch.cuda.device(raw.device):
            err = lib.prr_peak_refine_split(
                raw.data_ptr(), p, n, search_radius, centroid_radius, k, band_rows, vec,
                scratch.data_ptr(), counters.data_ptr(), shift.data_ptr(), maxval.data_ptr(),
                index.data_ptr() if with_index else None,
                torch.cuda.current_stream(raw.device).cuda_stream,
            )
        _check_launch(err, "peak_refine_raw")
        peak_refine_raw.LAUNCHES += 1
    return (shift, maxval, index.long()) if with_index else (shift, maxval)


peak_refine_raw.LAUNCHES = 0


# --------------------------------------------------------------------------- #
# kernel C: block-matching SAD maps                                            #
# --------------------------------------------------------------------------- #


#: kernel C's constants, as ``csrc/sad_search.cu`` states them: row shifts
#: and column shifts a warp (its register tile), block rows a warp (one a
#: lane), warps a block at most, columns a band at most
SAD_TI, SAD_TJ, SAD_ROWS, SAD_WARPS, SAD_MAX_BAND = 2, 11, 32, 8, 256
#: blocks below which kernel C splits the block columns into bands: one on
#: each of an H100's 132 SMs; a band keeps at least SAD_MIN_BAND columns
SAD_FILL_BLOCKS = 132
SAD_MIN_BAND = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class SadGeometry(NamedTuple):
    """Kernel C's launch geometry for one call (``make_geometry`` in
    ``csrc/sad_search.cu`` derives the same from ``g, s, r, xb``)."""

    xb: int  # columns a band
    n_xb: int  # column bands
    n_rg: int  # 32-row groups
    parts: int  # n_rg * n_xb: the partial sums of each shift, merged in order
    ni: int  # row-shift tiles a block
    nj: int  # column-shift tiles a block
    n_dib: int  # row-shift bands
    n_djb: int  # column-shift bands
    threads: int  # threads a block
    blocks: int
    smem: int  # dynamic shared memory a block, bytes
    scratch: int  # float64 partials
    counters: int


def sad_smem_bytes(r: int, xb: int) -> int:
    """Kernel C's dynamic shared memory a block at radius ``r`` and band
    width ``xb``: the staged block rows and region rows (odd pitches), or the
    warps' row partials, whichever is larger (``sad_smem_bytes`` in
    ``csrc/sad_search.cu``)."""
    ni, nj = _sad_tiles(r)

    def odd(n):
        return n | 1

    return 4 * max(SAD_ROWS * odd(xb) + (SAD_ROWS + ni * SAD_TI - 1) * odd(xb + nj * SAD_TJ),
                   ni * nj * SAD_TI * SAD_TJ * (SAD_ROWS + 1))


def _sad_tiles(r: int) -> Tuple[int, int]:
    """(row-shift tiles, column-shift tiles) a block: as many column tiles
    as the shifts need, up to SAD_WARPS, then row tiles up to SAD_WARPS
    warps."""
    d = 2 * r + 1
    nj = min(_cdiv(d, SAD_TJ), SAD_WARPS)
    return min(_cdiv(d, SAD_TI), SAD_WARPS // nj), nj


def sad_geometry(g: int, s: int, r: int) -> SadGeometry:
    """Kernel C's geometry for ``g`` cells of ``s x s`` blocks at radius
    ``r``: one block a (cell, row-shift band, column-shift band, row group,
    column band); one band while the others give SAD_FILL_BLOCKS blocks,
    else as many bands as reach it (each at least SAD_MIN_BAND columns).
    396 blocks of 256 threads at the node's ``g, s, r = 9, 120, 21``; 132
    blocks in 3 bands of 40 columns at ``g = 1``."""
    d = 2 * r + 1
    ni, nj = _sad_tiles(r)
    n_dib, n_djb = _cdiv(_cdiv(d, SAD_TI), ni), _cdiv(_cdiv(d, SAD_TJ), nj)
    n_rg = _cdiv(s, SAD_ROWS)
    base = g * n_dib * n_djb * n_rg
    n_xb = _cdiv(s, SAD_MAX_BAND)
    while base * n_xb < SAD_FILL_BLOCKS and _cdiv(s, n_xb + 1) >= SAD_MIN_BAND:
        n_xb += 1
    xb = _cdiv(s, n_xb)
    n_xb = _cdiv(s, xb)
    parts = n_rg * n_xb
    regions = g * n_dib * n_djb
    return SadGeometry(
        xb=xb, n_xb=n_xb, n_rg=n_rg, parts=parts, ni=ni, nj=nj, n_dib=n_dib, n_djb=n_djb,
        threads=32 * ni * nj, blocks=regions * parts, smem=sad_smem_bytes(r, xb),
        scratch=regions * parts * ni * SAD_TI * nj * SAD_TJ, counters=regions,
    )


def sad_search(
    curr_blocks: torch.Tensor,
    prev_regions: torch.Tensor,
    *,
    block_size: int,
    scan_radius: int,
) -> torch.Tensor:
    """Kernel C: ``[G, S, S]`` current blocks and ``[G, S+2R, S+2R]``
    previous regions (float32) -> ``[G, D, D]`` float32 SAD maps, D = 2R+1,
    rows the y shift and columns the x shift (the contract of
    :func:`~mrs_optic_flow_tpu_torch.ops.block_matching.sad_search`).

    CPU tensors run that plain twin.  CUDA tensors launch
    ``csrc/sad_search.cu`` on the current stream, in the blocks
    :func:`sad_geometry` names; each launch adds one to
    ``sad_search.LAUNCHES``.
    """
    if curr_blocks.device.type == "cpu" and prev_regions.device.type == "cpu":
        return block_matching.sad_search(
            curr_blocks, prev_regions, block_size=block_size, scan_radius=scan_radius
        )
    _check_cuda("sad_search", curr_blocks, prev_regions)
    s, r = block_size, scan_radius
    g = curr_blocks.shape[0]
    if curr_blocks.dtype != torch.float32 or prev_regions.dtype != torch.float32:
        raise ValueError(f"expected float32 blocks, got {curr_blocks.dtype} and {prev_regions.dtype}")
    if (tuple(curr_blocks.shape) != (g, s, s)
            or tuple(prev_regions.shape) != (g, s + 2 * r, s + 2 * r)):
        raise ValueError(
            f"expected [G, {s}, {s}] blocks and [G, {s + 2 * r}, {s + 2 * r}] regions, "
            f"got {tuple(curr_blocks.shape)} and {tuple(prev_regions.shape)}"
        )
    if s <= 0 or r < 0:
        raise ValueError("block_size must be positive and scan_radius non-negative")
    d = 2 * r + 1
    dev = curr_blocks.device
    out = torch.empty((g, d, d), dtype=torch.float32, device=dev)
    if g:
        lib = load_library("sad_search")
        geo = sad_geometry(g, s, r)
        _smem_fits(geo.smem, dev, f"block {s}, radius {r}, bands of {geo.xb} columns")
        scratch = torch.empty((geo.scratch,), dtype=torch.float64, device=dev)
        counters = _counters("sad_search", dev, geo.counters)
        with torch.cuda.device(dev):
            err = lib.sad_search_tiled(
                curr_blocks.data_ptr(), prev_regions.data_ptr(), g, s, r, geo.xb,
                scratch.data_ptr(), counters.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _check_launch(err, "sad_search")
        sad_search.LAUNCHES += 1
    return out


sad_search.LAUNCHES = 0


# --------------------------------------------------------------------------- #
# kernels D and E: patch-batch phase correlation of any patch size            #
# --------------------------------------------------------------------------- #

#: scratch of one chunk of kernel D or E: a chunk's intermediates stay in
#: the card's 50 MB L2 cache
CHUNK_SCRATCH_BYTES = 32 << 20
#: chunk bound from the launch grids' y dimension (2 * chunk <= 65535)
MAX_CHUNK = 16384


def _chunk(p: int, pair_bytes: int) -> int:
    if not pair_bytes:  # a design without scratch takes the batch at once
        return max(1, p)
    return max(1, min(p, CHUNK_SCRATCH_BYTES // pair_bytes, MAX_CHUNK))


#: kernel D's constants, as ``csrc/phase_correlate_fullfused.cu`` states
#: them: the largest buffer side of its one-block design (8 W^2 B of shared
#: memory plus the static reserve, W = n + n % 2), packed rows a block and
#: columns a band in its staged design, and those passes' shared-memory target
PCFF_MAX_SMALL = 170
PCFF_LINES, PCFF_BAND, PCFF_SMEM_CAP = 4, 4, 96 * 1024
#: threads a block of the one-block design, and the static shared memory it
#: may use (its perm table, its warps' exact bins, the argmax's words)
PCFF_SMALL_THREADS, PCFF_STATIC_RESERVE = 512, 1248
#: the radices kernel D's FFT unrolls, in the order its plan takes them, and
#: the largest prime it sums directly (a generic radix)
FFT_RADICES = (8, 4, 2, 3, 5)
FFT_MAX_GENERIC_RADIX = 1024


def fft_plan(n: int) -> Tuple[int, ...]:
    """Radices of kernel D's FFT of length ``n`` in stage order
    (``fft::make_plan`` in ``csrc/fft_stages.cuh``): 8 while it divides,
    then 4, 2, 3 and 5, then the remaining prime factors ascending."""
    if n < 1:
        raise ValueError(f"no FFT plan for n = {n}")
    plan, rest = [], n
    for r in FFT_RADICES:
        while rest % r == 0 and rest > 1:
            plan.append(r)
            rest //= r
    p = 7
    while rest > 1:
        while rest % p == 0:
            plan.append(p)
            rest //= p
        p += 2
    return tuple(plan)


def pcff_small(n: int) -> bool:
    """Kernel D's route: its one-block design for n <= PCFF_MAX_SMALL, its
    staged passes beyond (``small_route`` in the source)."""
    w = n + n % 2
    return 8 * w * w + PCFF_STATIC_RESERVE <= H100_SMEM_OPTIN_BYTES


def _pass_lines(line_bytes: int, most: int) -> int:
    """Lines of ``line_bytes`` each in one block of a staged pass of kernel
    D or E: as many as PCFF_SMEM_CAP holds, at least 1, at most ``most``
    (``fft::pass_lines`` in ``csrc/fft_stages.cuh``)."""
    return max(1, min(most, PCFF_SMEM_CAP // line_bytes))


def pcff_smem_bytes(n: int) -> int:
    """Kernel D's largest dynamic shared memory for patch ``n``
    (``pcff_smem_bytes`` in the source): the one-block design's W x W
    complex buffer, or the staged design's row pass (PCFF_LINES lines and a
    perm table) or column pass (PCFF_BAND columns of both patches)."""
    if pcff_small(n):
        w = n + n % 2
        return 8 * w * w
    lines = _pass_lines(8 * n + 4, PCFF_LINES)
    band = _pass_lines(16 * n + 4, PCFF_BAND)
    return max(lines * n * 8 + 4 * n, 16 * band * n)


def pcff_scratch_bytes(n: int) -> int:
    """Kernel D's scratch a pair: none for the one-block design; for the
    staged one two half spectra ``[n, n/2 + 1]`` complex and the peak's
    parts and counter."""
    return 0 if pcff_small(n) else 16 * n * (n // 2 + 1) + 12 * n + 4


def _check_pairs(what: str, dtypes, curr: torch.Tensor, prev: torch.Tensor,
                 search_radius: int, centroid_radius: int) -> None:
    """Raise on anything kernels D and E do not take: two contiguous
    ``[P, N, N]`` batches of one dtype in ``dtypes`` on one CUDA device."""
    _check_cuda(what, curr, prev)
    if curr.dtype not in dtypes or prev.dtype != curr.dtype:
        raise ValueError(f"{what}: expected {' or '.join(str(d) for d in dtypes)} patches of one "
                         f"dtype, got {curr.dtype} and {prev.dtype}")
    if curr.ndim != 3 or curr.shape[-1] != curr.shape[-2] or prev.shape != curr.shape:
        raise ValueError(f"{what}: expected two [P, N, N] batches, got {tuple(curr.shape)} "
                         f"and {tuple(prev.shape)}")
    if search_radius < 0 or centroid_radius < 0:
        raise ValueError("radii must be non-negative")


def _check_fft_patch(what: str, curr: torch.Tensor, smem_bytes) -> None:
    """Raise on a patch size that kernel D's or E's FFT plan or shared
    memory (``smem_bytes(n)``) does not take."""
    n = curr.shape[-1]
    if n and max(fft_plan(n), default=1) > FFT_MAX_GENERIC_RADIX:
        raise ValueError(f"{what} takes patches whose prime factors are at most "
                         f"{FFT_MAX_GENERIC_RADIX}, not {n}")
    if n:
        _smem_fits(smem_bytes(n), curr.device, f"{what} at patch {n}")


def _launch_staged(wrapper, prefix: str, inputs: tuple, curr: torch.Tensor,
                   search_radius: int, centroid_radius: int, split_peak: bool = False):
    """Launch kernel D or E (library ``wrapper.__name__``, C functions
    ``<prefix>_scratch_bytes`` and ``<prefix>_<name>``) over the ``[P, N,
    N]`` batch shaped like ``curr``, its leading arguments ``inputs`` (data
    pointers and flags, whose tensors the caller holds), with a scratch of
    ``_chunk`` pairs (none where the kernel needs none); ``split_peak``
    passes kernel B's :func:`peak_split` of a chunk after the radii.  Adds
    one to ``wrapper.LAUNCHES``.  Returns ``(shift [P, 2], maxval [P])``."""
    name = wrapper.__name__
    p, n = curr.shape[0], curr.shape[-1]
    shift = torch.empty((p, 2), dtype=torch.float32, device=curr.device)
    maxval = torch.empty((p,), dtype=torch.float32, device=curr.device)
    if p and n:
        lib = load_library(name)
        pair_bytes = getattr(lib, f"{prefix}_scratch_bytes")(n)
        chunk = _chunk(p, pair_bytes)
        scratch = torch.empty((chunk * pair_bytes,), dtype=torch.uint8, device=curr.device)
        tab = _twiddles(n, curr.device)
        split = peak_split(chunk, n, search_radius) if split_peak else ()
        with torch.cuda.device(curr.device):
            err = getattr(lib, f"{prefix}_{name}")(
                *inputs, p, n, chunk, search_radius, centroid_radius, *split, tab.data_ptr(),
                scratch.data_ptr(), shift.data_ptr(), maxval.data_ptr(),
                torch.cuda.current_stream(curr.device).cuda_stream,
            )
        _check_launch(err, name)
        wrapper.LAUNCHES += 1
    return shift, maxval


def phase_correlate_fullfused_ref(
    curr: torch.Tensor,
    prev: torch.Tensor,
    *,
    search_radius: int = DEFAULT_SEARCH_RADIUS,
    centroid_radius: int = DEFAULT_CENTROID_RADIUS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of kernels D and E: the ``dft`` correlation
    surface (float32 matrix products: forward DFTs, cross-power, the
    inverse's real part; fftshift and mask) and the peak refine of
    :mod:`~mrs_optic_flow_tpu_torch.ops.phase_correlate`.  Same contract as
    :func:`phase_correlate_fullfused`."""
    surf = correlation_surface(curr, prev, search_radius=search_radius, backend="dft")
    return peak_refine(surf, centroid_radius=centroid_radius)


#: kernel E computes the function of kernel D from the forward spectra: one twin
phase_correlate_fused_ref = phase_correlate_fullfused_ref


def phase_correlate_fullfused(
    curr: torch.Tensor,
    prev: torch.Tensor,
    *,
    search_radius: int = DEFAULT_SEARCH_RADIUS,
    centroid_radius: int = DEFAULT_CENTROID_RADIUS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D: ``[P, N, N]`` patch pairs (uint8 or float32, any N >= 1
    whose prime factors are at most FFT_MAX_GENERIC_RADIX) -> ``(shift
    [P, 2], maxval [P])``; uint8 and float32 patches of the same values
    give bit-identical results.

    CPU tensors run :func:`phase_correlate_fullfused_ref`.  CUDA tensors
    launch ``csrc/phase_correlate_fullfused.cu`` on the current stream: one
    block a pair for N <= PCFF_MAX_SMALL, else four staged launches,
    ``CHUNK_SCRATCH_BYTES`` of pairs at a time, the last kernel B's split
    peak over the blocks :func:`peak_split` names; each call adds one to
    ``phase_correlate_fullfused.LAUNCHES``.
    """
    if curr.device.type == "cpu" and prev.device.type == "cpu":
        return phase_correlate_fullfused_ref(
            curr, prev, search_radius=search_radius, centroid_radius=centroid_radius,
        )
    _check_pairs("phase_correlate_fullfused", (torch.uint8, torch.float32), curr, prev,
                 search_radius, centroid_radius)
    _check_fft_patch("kernel D", curr, pcff_smem_bytes)
    inputs = (curr.data_ptr(), prev.data_ptr(), int(curr.dtype == torch.uint8))
    return _launch_staged(phase_correlate_fullfused, "pcff", inputs, curr, search_radius,
                          centroid_radius, split_peak=True)


phase_correlate_fullfused.LAUNCHES = 0


def pcfu_smem_bytes(n: int) -> int:
    """Kernel E's largest dynamic shared memory for patch ``n``
    (``pcfu_smem_bytes`` in the source; E takes kernel D's route,
    :func:`pcff_small`): the one-block design's n x n complex
    buffer, or the staged design's row pass (PCFF_LINES rows and a perm
    table) or column pass (PCFF_BAND columns of one surface)."""
    if pcff_small(n):
        return 8 * n * n
    return max(8 * _pass_lines(8 * n + 4, PCFF_LINES) * n + 4 * n,
               8 * _pass_lines(8 * n, PCFF_BAND) * n)


def pcfu_scratch_bytes(n: int) -> int:
    """Kernel E's scratch a pair: none for the one-block design; for the
    staged one its surface ``[n, n]`` float32, its row pass's output ``[n,
    n]`` complex at the widest window, and the peak's parts and counter."""
    return 0 if pcff_small(n) else 12 * n * n + 12 * n + 4


def half_cols(n: int) -> int:
    """Columns of a patch's half spectrum in kernel E's forward products:
    n/2 + 1 rounded up to even, so that every patch's block of G starts
    16-byte aligned (``half_cols`` in ``csrc/phase_correlate_fused.cu``)."""
    return (n // 2 + 2) & ~1


@functools.lru_cache(maxsize=None)
def _dft_blocks(n: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[Ch | Sh]`` (``[n, 2h]``: the first n/2 + 1 columns of C and of S,
    zero-padded to ``h = half_cols(n)``) and ``[C ; S]`` (``[2n, n]``) of
    :func:`_dft_matrices` on ``device``: kernel E's forward products."""
    c, s = _dft_matrices(n)
    half = np.zeros((n, 2, half_cols(n)), np.float32)
    half[:, 0, : n // 2 + 1] = c[:, : n // 2 + 1]
    half[:, 1, : n // 2 + 1] = s[:, : n // 2 + 1]
    return (torch.from_numpy(half.reshape(n, -1)).to(device),
            torch.from_numpy(np.vstack([c, s])).to(device))


@pinned
def _fused_spectra(x: torch.Tensor) -> torch.Tensor:
    """Kernel E's forward products of ``x`` ``[n, B, n]`` float32 (row y of
    patch b at ``x[y, b]``): ``T = x [Ch | Sh]``, then ``G = [C ; S] T``
    ``[2n, B * 2h]`` (:func:`_dft_blocks`), two matrix products.  The
    patches are real, so their row transforms are Hermitian and the
    columns kx <= n/2 carry them.  Patch b's columns ``2 h b ..`` of G hold
    ``[[C Tr, C Ti], [S Tr, S Ti]]``, so its spectrum ``W X W`` is ``(G00 -
    G11) + i (G01 + G10)`` at kx <= n/2, the products and sums of
    :func:`~mrs_optic_flow_tpu_torch.ops.phase_correlate._dft2_real`, and
    ``F(ky, kx) = conj F(-ky, -kx)`` beyond."""
    n, b = x.shape[0], x.shape[1]
    cs_half, cs_t = _dft_blocks(n, x.device)
    t = x.reshape(n * b, n) @ cs_half
    return cs_t @ t.view(n, b * 2 * half_cols(n))


def phase_correlate_fused(
    curr: torch.Tensor,
    prev: torch.Tensor,
    *,
    search_radius: int = DEFAULT_SEARCH_RADIUS,
    centroid_radius: int = DEFAULT_CENTROID_RADIUS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel E: ``[P, N, N]`` patch pairs of any real dtype, cast to
    float32 as the JAX function casts them (any N >= 1 whose prime factors
    are at most FFT_MAX_GENERIC_RADIX) -> ``(shift [P, 2], maxval [P])``;
    uint8 and float32 patches of the same values give bit-identical results.

    CPU tensors run :func:`phase_correlate_fused_ref`.  CUDA tensors make the
    forward spectra in three launches on the current stream: ``pcfu_stack``
    (both batches as one float32 matrix, uint8 converted exactly; other
    dtypes are cast to float32 first) and the two products of
    :func:`_fused_spectra`.  Then ``csrc/phase_correlate_fused.cu`` takes the
    cross-power, the inverse and the peak: one block a pair for N <=
    PCFF_MAX_SMALL, else three staged launches, ``CHUNK_SCRATCH_BYTES`` of
    pairs at a time, the last kernel B's split peak over the blocks
    :func:`peak_split` names.  Each call adds one to
    ``phase_correlate_fused.LAUNCHES``.
    """
    if curr.device.type == "cpu" and prev.device.type == "cpu":
        return phase_correlate_fused_ref(
            curr, prev, search_radius=search_radius, centroid_radius=centroid_radius,
        )
    if curr.dtype.is_complex or prev.dtype.is_complex:
        raise ValueError(f"phase_correlate_fused: expected real patches, got {curr.dtype} and {prev.dtype}")
    if curr.dtype != prev.dtype or curr.dtype not in (torch.uint8, torch.float32):
        curr, prev = curr.to(torch.float32), prev.to(torch.float32)
    _check_pairs("phase_correlate_fused", (torch.uint8, torch.float32), curr, prev, search_radius,
                 centroid_radius)
    _check_fft_patch("kernel E", curr, pcfu_smem_bytes)
    p, n = curr.shape[0], curr.shape[-1]
    if not (p and n):
        return _launch_staged(phase_correlate_fused, "pcfu", (None,), curr, search_radius,
                              centroid_radius)
    x = torch.empty((n, 2 * p, n), dtype=torch.float32, device=curr.device)
    with torch.cuda.device(curr.device):
        err = load_library("phase_correlate_fused").pcfu_stack(
            curr.data_ptr(), prev.data_ptr(), int(curr.dtype == torch.uint8), p, n, x.data_ptr(),
            torch.cuda.current_stream(curr.device).cuda_stream,
        )
    _check_launch(err, "phase_correlate_fused")
    spec = _fused_spectra(x)
    return _launch_staged(phase_correlate_fused, "pcfu", (spec.data_ptr(),), curr, search_radius,
                          centroid_radius, split_peak=True)


phase_correlate_fused.LAUNCHES = 0
