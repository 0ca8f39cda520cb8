"""Log-polar resampling (the ``cv::logPolar`` equivalent) in plain PyTorch.

Port of :mod:`mrs_optic_flow_tpu.ops.logpolar`, which feeds the
scale/rotation estimator (``src/scaleRotationEstimator.cpp:34-148``).  Same
sampling convention: output pixel ``(row = phi_idx, col = rho_idx)`` samples
the source at ``center + (exp(rho_idx / M) - 1) * (cos phi, sin phi)``,
``phi = phi_idx * 2 pi / rows``, ``center = (N/2, N/2)``; the Lanczos-4
(8 taps, per-axis weights normalized to unit sum, OpenCV's
``INTER_LANCZOS4``) or bilinear (2 taps) stencil; zero outside the image
(``cv::remap`` BORDER_CONSTANT); and the static rho trim: columns whose
radius puts every tap outside the image are zero and are not computed.

The JAX package resamples with one-hot matrix products laid out for the
TPU's matrix unit (an octant-symmetric precomputed plan with bf16 hi/lo
weight splits, and a per-frame fallback when ``res % 8 != 0``).  Here one
tap table per geometry (flat source indices and the products of the two
axes' weights, built in float64 and cast to float32) is built once on the
device, and every frame is one gather and one weighted sum in float32.  That
single path covers every resolution.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

#: the 8 Lanczos-4 taps around floor(coord)
_LANCZOS4_OFFSETS = np.arange(-3, 5)
_BILINEAR_OFFSETS = np.arange(2)


def _interp_offsets(interp: str) -> np.ndarray:
    if interp == "lanczos4":
        return _LANCZOS4_OFFSETS
    if interp == "bilinear":
        return _BILINEAR_OFFSETS
    raise ValueError(f"unknown interp {interp!r} (expected 'lanczos4' or 'bilinear')")


def _tap_weights(frac: np.ndarray, interp: str) -> np.ndarray:
    """float64 tap weights ``[..., T]`` for fractional offsets in [0, 1):
    ``L(t) = sinc(t) sinc(t/4)`` normalized to unit sum (Lanczos-4), or
    ``(1 - f, f)`` (bilinear)."""
    if interp == "lanczos4":
        t = frac[..., None] - _LANCZOS4_OFFSETS.astype(np.float64)
        w = np.sinc(t) * np.sinc(t / 4.0)
        return w / np.sum(w, axis=-1, keepdims=True)
    return np.stack([1.0 - frac, frac], axis=-1)


def static_trim(n: int, res: int, magnitude: float, offsets: np.ndarray) -> int:
    """Live log-polar column count: a column contributes only while some tap
    lands inside the image, so columns farther from the centre than the
    image corner plus the stencil margin are all zero.  Rounded up to a
    multiple of 128 as in the JAX package, so both compute the same columns."""
    margin = float(max(abs(int(offsets[0])), int(offsets[-1]))) + 1.0
    r_max = float(np.sqrt(2.0)) * (n / 2.0 + margin)
    r_np = np.exp(np.arange(res, dtype=np.float64) / magnitude) - 1.0
    c_used = int(np.searchsorted(r_np > r_max, True))
    return min(res, -(-max(c_used, 1) // 128) * 128)


def tap_table(n: int, res: int, magnitude: float, interp: str) -> Tuple[np.ndarray, np.ndarray]:
    """The resample of an ``[n, n]`` image to ``[res, c_used]`` as a tap
    table: flat source indices ``[res, c_used, T*T]`` (int64) and weights
    (float32, the float64 product of the y and x tap weights).  A tap
    outside the image has weight 0 and index 0."""
    offsets = _interp_offsets(interp)
    c_used = static_trim(n, res, magnitude, offsets)
    r = np.exp(np.arange(c_used, dtype=np.float64) / magnitude) - 1.0
    phi = np.arange(res, dtype=np.float64) * (2.0 * np.pi / res)
    x = n / 2.0 + r[None, :] * np.cos(phi)[:, None]
    y = n / 2.0 + r[None, :] * np.sin(phi)[:, None]

    def axis(u):
        u0 = np.floor(u)
        w = _tap_weights(u - u0, interp)  # [res, c_used, T]
        j = u0.astype(np.int64)[..., None] + offsets
        ok = (j >= 0) & (j < n)
        return np.where(ok, j, 0), np.where(ok, w, 0.0)

    jy, wy = axis(y)
    jx, wx = axis(x)
    idx = jy[..., :, None] * n + jx[..., None, :]
    w = wy[..., :, None] * wx[..., None, :]
    t = len(offsets)
    return idx.reshape(res, c_used, t * t), w.reshape(res, c_used, t * t).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_table(n: int, res: int, magnitude: float, interp: str, device: torch.device):
    idx, w = tap_table(n, res, magnitude, interp)
    return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


def logpolar(
    img: torch.Tensor,
    magnitude: float,
    *,
    resolution: Optional[int] = None,
    interp: str = "lanczos4",
) -> torch.Tensor:
    """Log-polar transform of square ``[..., N, N]`` images ->
    ``[..., res, res]`` float32, ``res = resolution or N``.  ``magnitude``
    is the reference's ``optimM`` (``scale_rot_magnitude``).  The tap table
    is built once per geometry and device."""
    n = img.shape[-1]
    if img.shape[-2] != n:
        raise ValueError(f"log-polar input must be square, got {tuple(img.shape[-2:])}")
    res = resolution or n
    idx, w = _device_table(n, res, float(magnitude), interp, img.device)
    lead = img.shape[:-2]
    flat = img.reshape((-1, n * n)).to(torch.float32)
    taps = flat[:, idx.reshape(-1)].reshape((flat.shape[0],) + tuple(w.shape))
    out = (taps * w).sum(dim=-1)  # [B, res, c_used]
    c_used = w.shape[1]
    if c_used < res:
        out = torch.nn.functional.pad(out, (0, res - c_used))
    return out.reshape(lead + (res, res))
