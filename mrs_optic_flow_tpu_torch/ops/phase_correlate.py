"""Batched phase correlation in plain PyTorch — the math of the compute core.

Port of :mod:`mrs_optic_flow_tpu.ops.phase_correlate`.  The math chain per
patch is the reference's fused OpenCL ``phaseCorrelateField``
(``cl/FftMethod.cl:1381-1485``):

1. forward 2-D real DFT of both patches,
2. normalized cross-power ``R = F1 * conj(F2) / sqrt(|F1*conj(F2)|^2 +
   FLT_EPSILON)`` (``cmulnormf``, ``cl/FftMethod.cl:976-982``),
3. inverse 2-D DFT with ``1/N^2`` scaling,
4. fftshift + zeroing of shifts beyond ``search_radius`` on both axes,
5. argmax with lowest-flat-index ties (in fftshifted space),
6. positive-only weighted centroid over a ``(2*radius+1)^2`` window with an
   FLT_EPSILON-seeded denominator,
7. result relative to the patch centre ``(N//2, N//2)``.

Sign convention: the returned shift ``d`` satisfies ``curr(x) ~= prev(x - d)``.

These functions are the plain twins of the hand-written CUDA kernels A and
B in :mod:`mrs_optic_flow_tpu_torch.ops.cuda_kernels`.  Two spectral backends:
``"dft"`` (DFT as float32 matrix products with tables built in float64, the
JAX package's MXU formulation) and ``"fft"`` (``torch.fft``).  Inputs are
``[..., N, N]``; shifts come out ``[..., 2]`` in (x, y) order.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from mrs_optic_flow_tpu_torch.utils.precision import pinned

# float32 machine epsilon — FLT_EPSILON in the OpenCL kernel
# (cl/FftMethod.cl:979, :1352).
FLT_EPSILON = float(np.finfo(np.float32).eps)

#: default peak-search radius (SEARCH_RADIUS, src/FftMethod.cpp:819-822).
DEFAULT_SEARCH_RADIUS = 55

#: default weighted-centroid radius (cl/FftMethod.cl:1478).
DEFAULT_CENTROID_RADIUS = 3


@functools.lru_cache(maxsize=None)
def _dft_matrices(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag parts of the DFT matrix ``W[j,k] = exp(-2*pi*i*j*k/n)``,
    computed in float64 and cast to float32 — the same values as the JAX
    package's ``_dft_matrices``."""
    j = np.arange(n, dtype=np.float64)
    theta = -2.0 * np.pi * np.outer(j, j) / n
    return np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_tensors(n: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_dft_matrices` on ``device``, copied there once per size (at
    the log-polar size, 480, the two tables are 1.8 MB)."""
    c, s = _dft_matrices(n)
    return torch.from_numpy(c).to(device), torch.from_numpy(s).to(device)


@pinned
def _dft2_real(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D DFT of a real ``[..., n, n]`` input by matrix products: (re, im)."""
    c, s = _dft_tensors(x.shape[-1], x.device)
    tr = x @ c  # rows: T = X W (W is symmetric)
    ti = x @ s
    fr = c @ tr - s @ ti  # cols: F = W T
    fi = c @ ti + s @ tr
    return fr, fi


@pinned
def _idft2_real_output(rr: torch.Tensor, ri: torch.Tensor) -> torch.Tensor:
    """Real part of the inverse 2-D DFT (``1/N^2`` scaled); conj(W) = C - iS."""
    n = rr.shape[-1]
    c, s = _dft_tensors(n, rr.device)
    ur = rr @ c + ri @ s
    ui = ri @ c - rr @ s
    return (c @ ur + s @ ui) * (1.0 / (n * n))


def correlation_surface_raw(
    curr: torch.Tensor,
    prev: torch.Tensor,
    *,
    backend: str = "fft",
) -> torch.Tensor:
    """Raw phase-correlation surface ``[..., N, N]`` (steps 1-3): the inverse
    DFT output as it is, zero shift at ``(0, 0)``, neither shifted nor
    masked.  Kernel B (``cuda_kernels.peak_refine_raw``) reads it directly.

    ``backend="dft"`` runs the transforms as float32 ``torch.matmul``,
    pinned to full float32 whatever the process's TF32 setting
    (:mod:`~mrs_optic_flow_tpu_torch.utils.precision`)."""
    n = curr.shape[-1]
    if curr.shape[-2] != n:
        raise ValueError(f"patches must be square, got {curr.shape[-2]}x{n}")
    if prev.shape != curr.shape:
        raise ValueError(f"curr/prev shapes differ: {tuple(curr.shape)} vs {tuple(prev.shape)}")
    curr = curr.to(torch.float32)
    prev = prev.to(torch.float32)

    if backend == "fft":
        r = torch.fft.rfft2(curr) * torch.conj(torch.fft.rfft2(prev))
        r = r * torch.rsqrt(r.real * r.real + r.imag * r.imag + FLT_EPSILON)
        return torch.fft.irfft2(r, s=(n, n))
    if backend == "dft":
        f1r, f1i = _dft2_real(curr)
        f2r, f2i = _dft2_real(prev)
        rr = f1r * f2r + f1i * f2i  # F1 * conj(F2)
        ri = f1i * f2r - f1r * f2i
        denom = torch.rsqrt(rr * rr + ri * ri + FLT_EPSILON)
        return _idft2_real_output(rr * denom, ri * denom)
    raise ValueError(f"unknown backend {backend!r} (expected 'fft' or 'dft')")


def shift_and_mask(raw: torch.Tensor, search_radius: int) -> torch.Tensor:
    """Step 4 on a raw surface: fftshift, then zero every entry beyond
    ``search_radius`` from the centre ``(N//2, N//2)`` on either axis."""
    n = raw.shape[-1]
    surf = torch.fft.fftshift(raw, dim=(-2, -1))
    idx = (torch.arange(n, device=surf.device) - n // 2).abs() <= search_radius
    mask = idx[:, None] & idx[None, :]
    return torch.where(mask, surf, torch.zeros((), dtype=surf.dtype, device=surf.device))


def correlation_surface(
    curr: torch.Tensor,
    prev: torch.Tensor,
    *,
    search_radius: int = DEFAULT_SEARCH_RADIUS,
    backend: str = "fft",
) -> torch.Tensor:
    """fftshifted, radius-masked phase-correlation surface ``[..., N, N]``
    (steps 1-4): the zero-shift response sits at ``(N//2, N//2)`` and entries
    beyond ``search_radius`` on either axis are zero."""
    return shift_and_mask(correlation_surface_raw(curr, prev, backend=backend), search_radius)


def peak_refine(
    surf: torch.Tensor,
    *,
    centroid_radius: int = DEFAULT_CENTROID_RADIUS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax + positive-only weighted centroid (steps 5-7) on an fftshifted
    ``[..., N, N]`` surface.  Returns ``(shift [..., 2], maxval [...])``; a
    NaN surface gives NaN shifts and NaN maxval."""
    n = surf.shape[-1]
    flat = surf.reshape(surf.shape[:-2] + (n * n,))
    # torch.argmax returns the first maximal index (and a NaN's index when
    # there is one): the min-flat-index tie rule of minmaxloc
    loc = torch.argmax(flat, dim=-1)
    maxval = torch.gather(flat, -1, loc[..., None])[..., 0]
    yc = (loc // n)[..., None, None]
    xc = (loc % n)[..., None, None]

    rows = torch.arange(n, device=surf.device)[:, None]
    cols = torch.arange(n, device=surf.device)[None, :]
    in_win = ((rows - yc).abs() <= centroid_radius) & ((cols - xc).abs() <= centroid_radius)
    w = torch.where(in_win & (surf > 0.0), surf, torch.zeros((), dtype=surf.dtype, device=surf.device))
    denom = w.sum(dim=(-2, -1)) + FLT_EPSILON
    cx = (w * cols.to(surf.dtype)).sum(dim=(-2, -1)) / denom - (n // 2)
    cy = (w * rows.to(surf.dtype)).sum(dim=(-2, -1)) / denom - (n // 2)

    shift = torch.stack([cx, cy], dim=-1)
    shift = torch.where(torch.isnan(maxval)[..., None], torch.full_like(shift, float("nan")), shift)
    return shift, maxval


def phase_correlate_field(
    curr: torch.Tensor,
    prev: torch.Tensor,
    *,
    search_radius: int = DEFAULT_SEARCH_RADIUS,
    centroid_radius: int = DEFAULT_CENTROID_RADIUS,
    backend: str = "fft",
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched phase correlation of ``[..., N, N]`` patch pairs ->
    ``(shift [..., 2], maxval [...])``.  ``use_pallas`` (the JAX function's
    name for the reference's ``useOCL``) routes the peak stage through
    kernel B, which reads the raw surface; otherwise the surface is shifted,
    masked and refined here."""
    if use_pallas:
        from mrs_optic_flow_tpu_torch.ops.cuda_kernels import peak_refine_raw

        raw = correlation_surface_raw(curr, prev, backend=backend)
        return peak_refine_raw(raw, search_radius=search_radius, centroid_radius=centroid_radius)
    surf = correlation_surface(curr, prev, search_radius=search_radius, backend=backend)
    return peak_refine(surf, centroid_radius=centroid_radius)
