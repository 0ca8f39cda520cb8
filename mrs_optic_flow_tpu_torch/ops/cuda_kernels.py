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

Kernel G, :func:`get_rt`, replaces no TPU kernel (the JAX package computes
getRT in XLA): window shifts to twist in one launch, in place of the plain
version's ~1,000 (``csrc/get_rt.cu``), and on request the method-4 node's
body-frame summary head as its epilogue; its plain version is the torch
geometry, :func:`~mrs_optic_flow_tpu_torch.geometry.motion.get_rt_ref` and
:func:`~mrs_optic_flow_tpu_torch.geometry.batched.get_rt_batch_ref`, then
:func:`~mrs_optic_flow_tpu_torch.geometry.motion.rt_body_frame`.

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
import re
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
    "get_rt": "get_rt.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
#: flags of one source beside NVCC_FLAGS: kernel G keeps the plain
#: version's float32 rounding, so nothing may contract into a fused
#: multiply-add
SOURCE_FLAGS = {"get_rt": ("-fmad=false",)}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
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
    "get_rt": {
        "grt_smem_bytes": (_LL, [_I, _I, _I]),
        "grt_pair_smem_bytes": (_LL, [_I]),
        "grt_tile_bytes": (_LL, [_I, _I]),
        "grt_block_threads": (_I, [_I, _I, _I, _I]),
        "grt_block_smem": (_LL, [_I, _I, _I, _I]),
        # shifts, heights, dts, ulx, ulx_scalar, cam, dist, c2b, rate, hyp,
        # gumbel, g_si, g_sp, b, p, q, patch, iters, thr_pts, thr2, ok, rot,
        # tran, n_inl, n_inl64, ang_diff, rejected, detilt, summary, best,
        # inl, h, stream
        "grt_get_rt": (_I, [_P, _P, _P, _P, _F, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I,
                            _I, _I, _F, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P]),
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


def variant_path(name: str, defines: Dict[str, int]) -> pathlib.Path:
    """The library of kernel ``name`` built with ``defines`` (a tuning
    variant: ``build(names, defines=...)``): ``{"SAD_TI": 2, "SAD_TJ": 8}``
    -> ``libsad_search_SAD_TI2_SAD_TJ8.so``; the shipped build is
    :func:`library_path`."""
    return BUILD_DIR / f"lib{name}_{'_'.join(f'{k}{v}' for k, v in sorted(defines.items()))}.so"


def start_build(names: Optional[Iterable[str]] = None, *,
                defines: Optional[Dict[str, int]] = None) -> dict:
    """Start one ``nvcc`` a kernel of ``names`` (default: all), all at once,
    without waiting: with ``defines``, each passed as ``-DNAME=VALUE`` (the
    sources keep today's value of each such constant under ``#ifndef``) into
    its variant's library (:func:`variant_path`), else into the shipped one.
    Hand the result to :func:`finish_build`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = [f"-D{k}={v}" for k, v in sorted((defines or {}).items())]
    jobs = {}
    for name in names or SOURCES:
        out = variant_path(name, defines) if defines else library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), *flags, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    return jobs


def finish_build(jobs: dict) -> Dict[str, str]:
    """Wait for :func:`start_build`'s compiles and move each library into
    place.  Returns each kernel's compiler log (``-Xptxas=-v``: registers,
    shared memory and spills).  Raises on a failed build."""
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{SOURCES[name]}: nvcc failed ({proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def finish_variants(jobs: dict) -> dict:
    """Wait for variant builds started one a key (``{key:
    start_build([name], defines=...)}``): ``{key: {"log": its compiler
    log}}``, or ``{key: {"error": the failed build's message}}``, so that
    one variant that does not build leaves the others usable."""
    out = {}
    for key, job in jobs.items():
        try:
            (log,) = finish_build(job).values()
            out[key] = {"log": log}
        except RuntimeError as e:
            out[key] = {"error": str(e)[-2000:]}
    return out


def build(names: Optional[Iterable[str]] = None, *,
          defines: Optional[Dict[str, int]] = None) -> Dict[str, str]:
    """Compile the kernel libraries ``names`` (default: all) from the
    sources in the package, one ``nvcc`` process per source, all started
    together; with ``defines`` (``{macro: value}``) into the variant
    libraries of :func:`variant_path`, which :func:`load_variant` binds.
    Returns each kernel's compiler log.  Raises on a failed build."""
    return finish_build(start_build(names, defines=defines))


def ptxas_lines(log: str) -> list:
    """The register, shared-memory and spill lines of a ``-Xptxas=-v`` log,
    each after its kernel's template argument (``m=15``) where it has one."""
    lines, entry = [], ""
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            arg = re.search(r"ILi(\d+)E", m.group(1))
            entry = f"m={arg.group(1)}: " if arg else ""
        elif "registers" in line or "spill" in line:
            lines.append(entry + line.split(":", 1)[-1].strip())
    return lines


def _bind(name: str, path: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def load_variant(name: str, defines: Dict[str, int]) -> ctypes.CDLL:
    """Kernel ``name``'s variant library built with ``defines`` (it must
    have been built: ``build([name], defines=defines)``), bound."""
    return _bind(name, variant_path(name, defines))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s library, built first when missing or older than its
    source or a shared header."""
    lib_path = library_path(name)
    newest = max(p.stat().st_mtime for p in [CSRC / SOURCES[name], *CSRC.glob("*.cuh")])
    if not lib_path.exists() or newest > lib_path.stat().st_mtime:
        build([name])
    return _bind(name, lib_path)


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
    out = launch_phase_correlate_frames(
        None, curr, prev, patch=patch,
        search_radius=search_radius, centroid_radius=centroid_radius,
    )
    phase_correlate_frames.LAUNCHES += 1
    return out


def launch_phase_correlate_frames(
    lib: Optional[ctypes.CDLL],
    curr: torch.Tensor,
    prev: torch.Tensor,
    *,
    patch: int,
    search_radius: int = DEFAULT_SEARCH_RADIUS,
    centroid_radius: int = DEFAULT_CENTROID_RADIUS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A from ``lib`` on CUDA tensors, with the checks of
    :func:`phase_correlate_frames` and without its launch count: ``lib`` is
    a variant of the shipped library (:func:`load_variant`), for the tuning
    scripts, or None for the shipped one."""
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
    lib = lib or load_library("phase_correlate_frames")
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
#: lane), warps a block at most, columns a band at most.  The tile and the
#: warps are the source's defaults of ``SAD_TI``, ``SAD_TJ`` and
#: ``SAD_WARPS``; a tuning variant built with other values passes them to
#: :func:`sad_geometry` as ``tile``
SAD_TI, SAD_TJ, SAD_ROWS, SAD_WARPS, SAD_MAX_BAND = 2, 11, 32, 8, 256
#: (row shifts, column shifts, warps) of the shipped kernel
SAD_TILE = (SAD_TI, SAD_TJ, SAD_WARPS)
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


def sad_smem_bytes(r: int, xb: int, tile: Tuple[int, int, int] = SAD_TILE) -> int:
    """Kernel C's dynamic shared memory a block at radius ``r`` and band
    width ``xb``: the staged block rows and region rows (odd pitches), or the
    warps' row partials, whichever is larger (``sad_smem_bytes`` in
    ``csrc/sad_search.cu``), for the ``(ti, tj, warps)`` of ``tile``."""
    ti, tj, _ = tile
    ni, nj = _sad_tiles(r, tile)

    def odd(n):
        return n | 1

    return 4 * max(SAD_ROWS * odd(xb) + (SAD_ROWS + ni * ti - 1) * odd(xb + nj * tj),
                   ni * nj * ti * tj * (SAD_ROWS + 1))


def _sad_tiles(r: int, tile: Tuple[int, int, int] = SAD_TILE) -> Tuple[int, int]:
    """(row-shift tiles, column-shift tiles) a block: as many column tiles
    as the shifts need, up to ``warps``, then row tiles up to ``warps``
    warps."""
    ti, tj, warps = tile
    d = 2 * r + 1
    nj = min(_cdiv(d, tj), warps)
    return min(_cdiv(d, ti), warps // nj), nj


def sad_geometry(g: int, s: int, r: int, tile: Tuple[int, int, int] = SAD_TILE) -> SadGeometry:
    """Kernel C's geometry for ``g`` cells of ``s x s`` blocks at radius
    ``r``: one block a (cell, row-shift band, column-shift band, row group,
    column band); one band while the others give SAD_FILL_BLOCKS blocks,
    else as many bands as reach it (each at least SAD_MIN_BAND columns).
    396 blocks of 256 threads at the node's ``g, s, r = 9, 120, 21``; 132
    blocks in 3 bands of 40 columns at ``g = 1``.  ``tile`` is the
    ``(ti, tj, warps)`` the library was built with (a tuning variant's
    ``SAD_TI``, ``SAD_TJ``, ``SAD_WARPS``; the shipped ones by default)."""
    ti, tj, _ = tile
    d = 2 * r + 1
    ni, nj = _sad_tiles(r, tile)
    n_dib, n_djb = _cdiv(_cdiv(d, ti), ni), _cdiv(_cdiv(d, tj), nj)
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
        threads=32 * ni * nj, blocks=regions * parts, smem=sad_smem_bytes(r, xb, tile),
        scratch=regions * parts * ni * ti * nj * tj, counters=regions,
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
    out = launch_sad_search(None, curr_blocks, prev_regions, block_size=block_size,
                            scan_radius=scan_radius)
    if curr_blocks.shape[0]:
        sad_search.LAUNCHES += 1
    return out


def launch_sad_search(
    lib: Optional[ctypes.CDLL],
    curr_blocks: torch.Tensor,
    prev_regions: torch.Tensor,
    *,
    block_size: int,
    scan_radius: int,
    tile: Tuple[int, int, int] = SAD_TILE,
) -> torch.Tensor:
    """Kernel C from ``lib`` on CUDA tensors, with the checks of
    :func:`sad_search` and without its launch count: ``lib`` is a variant
    built with the ``(SAD_TI, SAD_TJ, SAD_WARPS)`` of ``tile``
    (:func:`load_variant`), for the tuning scripts, or None for the shipped
    library (and ``tile`` its own)."""
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
        lib = lib or load_library("sad_search")
        geo = sad_geometry(g, s, r, tile)
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


# --------------------------------------------------------------------------- #
# kernel G: getRT, window shifts to twist                                      #
# --------------------------------------------------------------------------- #

#: kernel G's block layout (a block a pair): threads a block at most
#: (``grt::kMaxThreads``, up to one pair an SM); beyond, the warps a pair
#: that fill ``grt::kFillWarps`` warps an SM; where that is one, the warp
#: layout: pairs a block and blocks an SM (``GRT_PAIRS``,
#: ``GRT_PAIR_BLOCKS``).  These mirrors of ``csrc/get_rt.cu``'s launch
#: shape are for the tests and the tuning script; a launch asks the library.
GRT_MAX_THREADS = 256
GRT_FILL_WARPS = 16
GRT_PAIR_SHAPE = (8, 4)


def grt_smem_bytes(p: int, threads: int, batched: bool) -> int:
    """Kernel G's dynamic shared memory for a block-layout block of
    ``threads`` at ``p`` windows (``grt::smem_bytes`` in
    ``csrc/get_rt.cu``): the refit's system ``[2P, 9]`` and Householder
    vector ``[2P]``, on the batched path two rows of draws ``[P + 1]`` a
    thread (the one scored, the next in flight), the four point components
    (all float32) and the valid and inlier flags (36,384 B batched at P =
    16, 256 threads)."""
    return 4 * 20 * p + (4 * 2 * threads * (p + 1) if batched else 0) + 4 * 4 * p + (2 * p + 7) // 8 * 8


def grt_pair_smem_bytes(p: int) -> int:
    """Kernel G's shared memory a pair of a warp-layout block (``grt::
    pair_smem_bytes``): a block's without draws, and the winner's
    homography and the refit's ``v^T A``, 9 floats each (1,640 B at P =
    16)."""
    return grt_smem_bytes(p, 0, False) + 4 * 18


def grt_tile_bytes(p: int, pairs: int) -> int:
    """A warp-layout block's two tiles of the draws of 32 hypotheses for its
    ``pairs`` pairs, a hypothesis's row padded by one float (``grt::
    tile_bytes``; 33,024 B at P = 16, 8 pairs)."""
    return 4 * 2 * 32 * (p * pairs + 1)


def grt_block_threads(p: int, iters: int, batched: bool, smem_limit: int,
                      most: int = GRT_MAX_THREADS) -> int:
    """Kernel G's threads a block-layout block (``grt::block_threads``): one
    a hypothesis up to ``most`` in whole warps, fewer where the staged
    draws pass ``smem_limit``; 0 where not even one warp fits."""
    t = -(-min(iters, most) // 32) * 32
    while t > 0 and grt_smem_bytes(p, t, batched) > smem_limit:
        t -= 32
    return t


def grt_pair_warps(b: int, sms: int, fill: int = GRT_FILL_WARPS) -> int:
    """Kernel G's warps a pair beyond one pair an SM (``grt::pair_warps``):
    the power of two, 1 to 8, nearest below ``fill`` warps an SM."""
    w = 8
    while w > 1 and w * b > fill * sms:
        w //= 2
    return w


def grt_block_pairs(b: int, sms: int, p: int, smem_limit: int, most: int = GRT_PAIR_SHAPE[0]) -> int:
    """Kernel G's pairs a warp-layout block of a call over ``b`` pairs on
    ``sms`` SMs (``grt::block_pairs``): ``most``, halved while that leaves
    fewer blocks than SMs, fewer where the block's shared memory passes
    ``smem_limit``; 0 where not even one fits."""
    n = most
    while n > 1 and n * sms > b:
        n //= 2
    while n > 0 and n * grt_pair_smem_bytes(p) + grt_tile_bytes(p, n) > smem_limit:
        n -= 1
    return n


def grt_launch(b: int, p: int, iters: int, batched: bool, sms: int, smem_limit: int, *,
               pairs: int = GRT_PAIR_SHAPE[0], fill: int = GRT_FILL_WARPS,
               warp_layout: bool = False) -> Tuple[int, int, bool]:
    """Kernel G's launch of a call over ``b`` pairs (``launch_shape`` in
    ``csrc/get_rt.cu``; ``pairs``, ``fill`` and ``warp_layout`` its
    ``GRT_PAIRS``, ``kFillWarps`` and ``GRT_WARP_LAYOUT``): threads a block
    (0 where it does not fit), its dynamic shared memory, and whether it is
    the warp layout."""
    if warp_layout and batched:
        warps = 1
    else:
        warps = grt_pair_warps(b, sms, fill) if b > sms else GRT_MAX_THREADS // 32
    if batched and warps == 1:
        n = grt_block_pairs(b, sms, p, smem_limit, pairs)
        return 32 * n, n * grt_pair_smem_bytes(p) + grt_tile_bytes(p, n), True
    t = grt_block_threads(p, iters, batched, smem_limit, 32 * warps)
    return t, grt_smem_bytes(p, t, batched), False


class GetRTOutputs(NamedTuple):
    """Kernel G's outputs, batch first: the fields of
    :class:`~mrs_optic_flow_tpu_torch.geometry.motion.GetRTResult`, with
    ``debug`` the best hypothesis ``[B]`` int32, its inlier set ``[B, P]``
    bool and the refit homography ``[B, 3, 3]`` (None without), and with
    ``detilt`` the summary head."""

    ok: torch.Tensor
    rot: torch.Tensor
    tran: torch.Tensor
    n_inliers: torch.Tensor
    ang_diff: torch.Tensor
    ang_diff_rejected: torch.Tensor
    best: Optional[torch.Tensor] = None
    inliers: Optional[torch.Tensor] = None
    h: Optional[torch.Tensor] = None
    #: with ``detilt``: the node's body-frame summary head ``[B, 9]``
    #: (:func:`~mrs_optic_flow_tpu_torch.geometry.motion.rt_body_frame`)
    summary: Optional[torch.Tensor] = None


def _f32(what: str, x: torch.Tensor, shape: tuple) -> None:
    if x.dtype != torch.float32 or tuple(x.shape) != shape:
        raise ValueError(f"get_rt: expected {what} float32 {shape}, got {x.dtype} {tuple(x.shape)}")


def get_rt(
    shifts: torch.Tensor,
    heights: torch.Tensor,
    dts: torch.Tensor,
    ul_corner_x,
    camera_matrix: torch.Tensor,
    dist_coeffs: Optional[torch.Tensor],
    c2b_quat: torch.Tensor,
    ang_rate_quats: torch.Tensor,
    *,
    frame_size: int,
    patch: int,
    shifted_pts_thr: int = 8,
    ransac_threshold: float = 0.01,
    hyp_idx: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
    detilt: Optional[torch.Tensor] = None,
):
    """Kernel G: getRT of ``[B, P, 2]`` window shifts -> the fields of
    :class:`~mrs_optic_flow_tpu_torch.geometry.motion.GetRTResult`, batch
    first (a ``GetRTOutputs`` without the debug fields).  The hypotheses are
    ``hyp_idx`` ``[I, 4]`` point indices (per pair: ``B = 1``, normalized by
    h22, ``n_inliers`` int64) or the top 4 of each column of ``gumbel``
    ``[I, P, B]`` (batched: normalized by the largest entry, ``n_inliers``
    int32), exactly one of the two.  With ``detilt`` (float32 ``[4]``) also
    the node's body-frame summary head ``[B, 9]`` (``summary``).

    CPU tensors run the plain version (``geometry.motion.get_rt_ref`` or
    ``geometry.batched.get_rt_batch_ref``, then ``geometry.motion.
    rt_body_frame``).  CUDA tensors launch ``csrc/get_rt.cu`` on the current
    stream; each launch adds one to ``get_rt.LAUNCHES``.
    """
    kw = dict(frame_size=frame_size, patch=patch, shifted_pts_thr=shifted_pts_thr,
              ransac_threshold=ransac_threshold)
    if shifts.device.type == "cpu":
        from mrs_optic_flow_tpu_torch.geometry import batched, motion  # noqa: PLC0415 (a cycle)

        if (hyp_idx is None) == (gumbel is None):
            raise ValueError("get_rt: give exactly one of hyp_idx and gumbel")
        if hyp_idx is not None:
            res = motion.get_rt_ref(shifts[0], heights[0], dts[0], ul_corner_x, camera_matrix,
                                    dist_coeffs, c2b_quat, ang_rate_quats[0], hyp_idx=hyp_idx, **kw)
            res = motion.GetRTResult(*(x[None] for x in res))
        else:
            res = batched.get_rt_batch_ref(shifts, heights, dts, ul_corner_x, camera_matrix, dist_coeffs,
                                           c2b_quat, ang_rate_quats, gumbel=gumbel,
                                           ransac_iterations=gumbel.shape[0], **kw)
        summary = None if detilt is None else motion.rt_body_frame(res, c2b_quat, detilt)
        return GetRTOutputs(*res, summary=summary)
    out = launch_get_rt(shifts, heights, dts, ul_corner_x, camera_matrix, dist_coeffs, c2b_quat,
                        ang_rate_quats, hyp_idx=hyp_idx, gumbel=gumbel, detilt=detilt, **kw)
    get_rt.LAUNCHES += 1
    return out


def launch_get_rt(
    shifts: torch.Tensor,
    heights: torch.Tensor,
    dts: torch.Tensor,
    ul_corner_x,
    camera_matrix: torch.Tensor,
    dist_coeffs: Optional[torch.Tensor],
    c2b_quat: torch.Tensor,
    ang_rate_quats: torch.Tensor,
    *,
    frame_size: int,
    patch: int,
    shifted_pts_thr: int = 8,
    ransac_threshold: float = 0.01,
    hyp_idx: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
    detilt: Optional[torch.Tensor] = None,
    debug: bool = False,
    lib: Optional[ctypes.CDLL] = None,
) -> GetRTOutputs:
    """Kernel G on CUDA tensors, with the checks of :func:`get_rt` and
    without its launch count; ``debug`` also returns the best hypothesis,
    its inlier set and the refit homography (for the comparison with the
    plain version); ``lib`` is a variant of the shipped library
    (:func:`load_variant`) or None for the shipped one."""
    if shifts.ndim != 3 or shifts.shape[-1] != 2:
        raise ValueError(f"get_rt: expected shifts [B, P, 2], got {tuple(shifts.shape)}")
    b, p = shifts.shape[:2]
    q = frame_size // patch
    if p != q * q:
        raise ValueError(f"get_rt: {p} windows, but a {frame_size} px frame of {patch} px "
                         f"patches has {q * q}")
    if p < 5:  # the refit needs 9 rows
        raise ValueError(f"get_rt: kernel G takes 5 windows or more, not {p}")
    _f32("shifts", shifts, (b, p, 2))
    _f32("heights", heights, (b,))
    _f32("dts", dts, (b,))
    _f32("camera_matrix", camera_matrix, (3, 3))
    _f32("c2b_quat", c2b_quat, (4,))
    _f32("ang_rate_quats", ang_rate_quats, (b, 4))
    if dist_coeffs is not None:
        _f32("dist_coeffs", dist_coeffs, (5,))
    if torch.is_tensor(ul_corner_x) and ul_corner_x.ndim:
        _f32("ul_corner_x", ul_corner_x, (b,))
    if detilt is not None:
        _f32("detilt", detilt, (4,))
    if (hyp_idx is None) == (gumbel is None):
        raise ValueError("get_rt: give exactly one of hyp_idx and gumbel")
    if hyp_idx is not None:
        if b != 1 or hyp_idx.ndim != 2 or hyp_idx.shape[1] != 4 or hyp_idx.dtype not in (
                torch.int64, torch.int32):
            raise ValueError(f"get_rt: expected one pair and hyp_idx [I, 4] int64, got B = {b}, "
                             f"{hyp_idx.dtype} {tuple(hyp_idx.shape)}")
        iters = hyp_idx.shape[0]
    else:
        if gumbel.dtype != torch.float32 or gumbel.ndim != 3 or tuple(gumbel.shape[1:]) != (p, b):
            raise ValueError(f"get_rt: expected gumbel float32 [I, {p}, {b}], got {gumbel.dtype} "
                             f"{tuple(gumbel.shape)}")
        if gumbel.stride(2) != 1:
            raise ValueError("get_rt: gumbel must have unit stride in B")
        iters = gumbel.shape[0]
    if iters < 1:
        raise ValueError("get_rt: no hypotheses")
    # then the device: every tensor on the shifts' CUDA device, contiguous
    # but the draws (a shard's slice of the batch's draws is a view)
    extra = [t for t in (dist_coeffs, hyp_idx, detilt) if t is not None]
    _check_cuda("get_rt", shifts, heights, dts, camera_matrix, c2b_quat, ang_rate_quats, *extra)
    dev = shifts.device
    if gumbel is not None and gumbel.device != dev:
        raise ValueError(f"get_rt: gumbel on {gumbel.device}, the shifts on {dev}")
    ulx, ulx_scalar = None, 0.0
    if torch.is_tensor(ul_corner_x):
        ulx = ul_corner_x.reshape(1).expand(b).contiguous() if ul_corner_x.ndim == 0 else ul_corner_x
        _check_cuda("get_rt", shifts, ulx)
    else:
        ulx_scalar = float(ul_corner_x)
    if hyp_idx is not None:
        hyp_idx = hyp_idx.to(torch.int64)
        g_si = g_sp = 0
    else:
        g_si, g_sp = gumbel.stride(0), gumbel.stride(1)
    lib = lib or load_library("get_rt")
    with torch.cuda.device(dev):
        fits = lib.grt_block_threads(b, p, iters, int(gumbel is not None))
    if not fits:
        raise ValueError(f"get_rt: {p} windows do not fit kernel G's shared memory on {dev}")
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    rot = torch.empty((b, 4), dtype=torch.float32, device=dev)
    tran = torch.empty((b, 3), dtype=torch.float32, device=dev)
    n_inl = torch.empty((b,), dtype=torch.int64 if hyp_idx is not None else torch.int32, device=dev)
    ang_diff = torch.empty((b,), dtype=torch.float32, device=dev)
    rejected = torch.empty((b,), dtype=torch.bool, device=dev)
    summary = None if detilt is None else torch.empty((b, 9), dtype=torch.float32, device=dev)
    best = inl = h = None
    if debug:
        best = torch.empty((b,), dtype=torch.int32, device=dev)
        inl = torch.empty((b, p), dtype=torch.bool, device=dev)
        h = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        err = lib.grt_get_rt(
            shifts.data_ptr(), heights.data_ptr(), dts.data_ptr(), ptr(ulx), ulx_scalar,
            camera_matrix.data_ptr(), ptr(dist_coeffs), c2b_quat.data_ptr(),
            ang_rate_quats.data_ptr(), ptr(hyp_idx), ptr(gumbel), g_si, g_sp, b, p, q, patch,
            iters, shifted_pts_thr, ransac_threshold * ransac_threshold, ok.data_ptr(),
            rot.data_ptr(), tran.data_ptr(), n_inl.data_ptr(), int(hyp_idx is not None),
            ang_diff.data_ptr(), rejected.data_ptr(), ptr(detilt), ptr(summary), ptr(best), ptr(inl),
            ptr(h), torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_launch(err, "get_rt")
    return GetRTOutputs(ok, rot, tran, n_inl, ang_diff, rejected, best, inl, h, summary)


get_rt.LAUNCHES = 0
