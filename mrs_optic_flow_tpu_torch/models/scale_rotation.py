"""Scale / rotation estimator via log-polar phase correlation.

Port of :mod:`mrs_optic_flow_tpu.models.scale_rotation`, the rebuild of
``scaleRotationEstimator`` (``src/scaleRotationEstimator.cpp``): log-polar
transform of each frame (Lanczos-4, ``:113``), phase correlation of
consecutive log-polar images, decode ``scale = exp(dx / M)`` and
``rot = (dy / Ky) * pi / 180`` (``:123-124``).  The node maps scale to
vertical velocity and rotation to yaw rate; the reference's node wiring is
commented out (``src/optic_flow.cpp:1629-1650``), the JAX node and this
port's make it live.

The correlation runs the raw surface through kernel B
(:func:`~mrs_optic_flow_tpu_torch.ops.cuda_kernels.peak_refine_raw`) with
``use_pallas``, else through the plain peak refine.  With
``backend="dft"`` the forward and inverse DFTs at the log-polar size (480 at
the defaults) are float32 ``torch.matmul``, pinned to full float32 whatever
the process's TF32 setting.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from mrs_optic_flow_tpu_torch.ops.cuda_kernels import peak_refine_raw, peak_refine_raw_ref
from mrs_optic_flow_tpu_torch.ops.logpolar import logpolar
from mrs_optic_flow_tpu_torch.ops.phase_correlate import correlation_surface_raw
from mrs_optic_flow_tpu_torch.ops.preprocess import quantize_u8
from mrs_optic_flow_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class ScaleRotState(NamedTuple):
    """``prev_logpolar``: the previous frame's log-polar image ``[lp, lp]``
    (uint8 with ``quantize_8bit``, else float32).  ``first``: host bool,
    True until the first frame."""

    prev_logpolar: torch.Tensor
    first: bool


class ScaleRotResult(NamedTuple):
    scale: torch.Tensor  # frame-to-frame scale factor (1.0 = none)
    rotation: torch.Tensor  # frame-to-frame rotation [rad]


@dataclasses.dataclass(frozen=True)
class ScaleRotationConfig:
    """The JAX estimator's parameters.  ``lp_rows_per_chunk`` and
    ``lp_batch_chunk`` schedule the JAX resample on the TPU: accepted so
    that the same arguments construct both estimators, and ignored."""

    resolution: int = 480  # square frame size
    magnitude: float = 49.9  # optimM (scale_rot_magnitude)
    #: log-polar image size; None = ``resolution``.  Magnitude and Ky are
    #: rescaled by ``lp_resolution / resolution`` so the decode keeps the
    #: configured magnitude's meaning
    lp_resolution: Optional[int] = None
    interp: str = "lanczos4"  # or "bilinear"
    backend: str = "dft"  # dft (float32 matmuls) | fft (torch.fft)
    use_pallas: bool = True  # kernel B for the peak stage (useOCL analogue)
    lp_rows_per_chunk: int = 8
    lp_batch_chunk: int = 1
    #: round incoming grays to uint8 before the resample and the log-polar
    #: image itself after it, as the reference's 8-bit pipeline does
    #: (``src/scaleRotationEstimator.cpp:108-117``)
    quantize_8bit: bool = True

    @property
    def lp_res(self) -> int:
        return self.lp_resolution or self.resolution


class ScaleRotationEstimator:
    def __init__(self, config: ScaleRotationConfig = ScaleRotationConfig(), *, device=DEFAULT_DEVICE):
        if config.backend not in ("dft", "fft"):
            raise ValueError(f"unknown backend {config.backend!r} (expected 'fft' or 'dft')")
        if config.interp not in ("lanczos4", "bilinear"):
            raise ValueError(f"unknown interp {config.interp!r} (expected 'lanczos4' or 'bilinear')")
        self.config = config
        self.device = resolve_device(device)
        r = config.lp_res / config.resolution
        #: effective optimM at the log-polar resolution
        self.m_eff = config.magnitude * r
        #: Ky = lp_rows / 360 (src/scaleRotationEstimator.cpp:28 at r = 1)
        self.ky = config.lp_res / 360.0

    def init_state(self) -> ScaleRotState:
        n = self.config.lp_res
        dt = torch.uint8 if self.config.quantize_8bit else torch.float32
        return ScaleRotState(prev_logpolar=torch.zeros((n, n), dtype=dt, device=self.device), first=True)

    def _ingest(self, frame: torch.Tensor) -> torch.Tensor:
        """Frame as resampled: rounded uint8 with ``quantize_8bit``, else
        float32 (the contract of ``FftMethod._ingest``)."""
        if not self.config.quantize_8bit:
            return frame.to(torch.float32)
        return quantize_u8(frame)

    def logpolar_batch(self, frames: torch.Tensor) -> torch.Tensor:
        """Log-polar images of ``[..., N, N]`` frames -> ``[..., lp, lp]``,
        round-and-saturated to uint8 with ``quantize_8bit`` (the reference's
        ``cv::logPolar`` writes an 8-bit image)."""
        c = self.config
        lp = logpolar(self._ingest(frames), self.m_eff, resolution=c.lp_res, interp=c.interp)
        return quantize_u8(lp) if c.quantize_8bit else lp

    def _correlate(self, lp_c: torch.Tensor, lp_p: torch.Tensor) -> torch.Tensor:
        """Shift ``[..., 2]`` between log-polar images ``[..., N, N]``."""
        c = self.config
        n = c.lp_res
        raw = correlation_surface_raw(lp_c, lp_p, backend=c.backend)
        peak = peak_refine_raw if c.use_pallas else peak_refine_raw_ref
        shift, _ = peak(raw, search_radius=n // 2)
        return shift

    def _decode(self, shift: torch.Tensor, gate) -> ScaleRotResult:
        """``pt`` -> (scale, rot) per ``src/scaleRotationEstimator.cpp:
        119-124``; ``gate`` True forces the no-estimate result (1, 0), as
        does a peak out of range (``:119-121``, both checks test pt.x) or a
        NaN peak."""
        n = self.config.lp_res
        pt = -shift  # back to the cv::phaseCorrelate sign
        bad = ~(pt[..., 0].abs() <= n / 2) | gate
        one, zero = torch.ones_like(pt[..., 0]), torch.zeros_like(pt[..., 0])
        scale = torch.where(bad, one, torch.exp(pt[..., 0] / self.m_eff))
        rot = torch.where(bad, zero, (pt[..., 1] / self.ky) * (math.pi / 180.0))
        return ScaleRotResult(scale=scale, rotation=rot)

    def step(self, state: ScaleRotState, frame: torch.Tensor) -> Tuple[ScaleRotState, ScaleRotResult]:
        """``processImage`` (``src/scaleRotationEstimator.cpp:34-148``) on a
        gray ``[N, N]`` frame.  The first frame returns (1, 0) (``:74-75``)."""
        lp = self.logpolar_batch(frame)
        prev_lp = lp if state.first else state.prev_logpolar
        result = self._decode(self._correlate(lp, prev_lp), state.first)
        return ScaleRotState(prev_logpolar=lp, first=False), result

    def step_batch(self, prev_frames: torch.Tensor, curr_frames: torch.Tensor) -> ScaleRotResult:
        """Stateless batched mode: ``[B, N, N]`` frame pairs -> per-pair
        (scale [B], rotation [B])."""
        lp_p = self.logpolar_batch(prev_frames)
        return self.step_batch_carried(lp_p, curr_frames)[1]

    def step_batch_carried(
        self, prev_lp: torch.Tensor, curr_frames: torch.Tensor
    ) -> Tuple[torch.Tensor, ScaleRotResult]:
        """Previous frames enter as their log-polar images ``[B, lp, lp]``
        (the fleet's carry), so each call resamples once per stream.
        Returns ``(curr_lp, result)``; ``curr_lp`` is the next call's
        ``prev_lp``."""
        lp_c = self.logpolar_batch(curr_frames)
        return lp_c, self._decode(self._correlate(lp_c, prev_lp), False)
