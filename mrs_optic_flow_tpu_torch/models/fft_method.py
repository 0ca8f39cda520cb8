"""FftMethod — the live flow engine (method 4 of the reference), short range.

Port of :mod:`mrs_optic_flow_tpu.models.fft_method`: a grid of
``sqNum x sqNum`` phase correlations per frame pair with validity gating
(``src/FftMethod.cpp:1680-1903``).  The routes follow the JAX engine's
``_correlate``:

- ``use_pallas=True, backend="dft"``: the whole-frame kernel A,
  :func:`~mrs_optic_flow_tpu_torch.ops.cuda_kernels.phase_correlate_frames`
  (the JAX package's ``patch % 8`` limit on it is a TPU rule, so there is
  no patch-batch route here);
- ``backend="fft"`` or ``use_pallas=False``: patchify, the raw correlation
  surface in plain PyTorch, then kernel B
  (:func:`~mrs_optic_flow_tpu_torch.ops.cuda_kernels.peak_refine_raw`)
  with ``use_pallas``, or the plain peak refine without it (the
  reference's ``useOCL: false``).

Each kernel runs as hand-written CUDA on the card and as its plain twin on
the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mrs_optic_flow_tpu_torch.models.base import FlowEngine, FlowResult, FlowState
from mrs_optic_flow_tpu_torch.ops.cuda_kernels import (
    peak_refine_raw,
    peak_refine_raw_ref,
    phase_correlate_frames,
)
from mrs_optic_flow_tpu_torch.ops.phase_correlate import (
    DEFAULT_CENTROID_RADIUS,
    DEFAULT_SEARCH_RADIUS,
    correlation_surface_raw,
)
from mrs_optic_flow_tpu_torch.ops.preprocess import patchify, quantize_u8


@dataclasses.dataclass(frozen=True)
class FftMethodConfig:
    """Static engine parameters (the FftMethod ctor args,
    ``src/FftMethod.cpp:1680-1684``).

    ``mxu_passes``, ``half_spectrum``, ``bands_per_step``, ``pairs_per_step``
    and ``band_stack`` are the JAX package's TPU tiling knobs: accepted so
    that the same arguments construct both engines, and ignored.
    """

    frame_size: int = 480
    sample_point_size: int = 120
    max_pixel_speed: float = 80.0
    search_radius: int = DEFAULT_SEARCH_RADIUS
    centroid_radius: int = DEFAULT_CENTROID_RADIUS
    long_range_ratio: int = 4
    backend: str = "dft"
    use_pallas: bool = True
    half_spectrum: bool = True
    bands_per_step: int | None = None
    pairs_per_step: int | None = None
    band_stack: int | None = None
    mxu_passes: bool | int = True
    #: carry ``imPrev`` as rounded 8-bit gray like the reference
    #: (``src/optic_flow.cpp:1597``); False carries float32
    quantize_8bit: bool = True

    def normalized(self) -> "FftMethodConfig":
        """Even frame size (``src/FftMethod.cpp:1707-1709``); a patch that
        does not divide the frame becomes the whole frame (``:1710-1716``)."""
        if self.backend not in ("dft", "fft"):
            raise ValueError(f"unknown backend {self.backend!r} (expected 'fft' or 'dft')")
        frame = self.frame_size - (self.frame_size % 2)
        patch = self.sample_point_size
        if frame % patch != 0:
            patch = frame
        if frame == self.frame_size and patch == self.sample_point_size:
            return self
        return dataclasses.replace(self, frame_size=frame, sample_point_size=patch)


class FftMethod(FlowEngine):
    """Multi-patch phase-correlation engine on ``device``."""

    def __init__(self, config: FftMethodConfig = FftMethodConfig(), *, device="cpu"):
        self.config = config.normalized()
        c = self.config
        self.device = torch.device(device)
        #: grid side (sqNum, src/FftMethod.cpp:1719)
        self.sq_num = c.frame_size // c.sample_point_size
        self.num_windows = self.sq_num * self.sq_num

    def init_state(self) -> FlowState:
        c = self.config
        dt = torch.uint8 if c.quantize_8bit else torch.float32
        return FlowState(
            prev=torch.zeros((c.frame_size, c.frame_size), dtype=dt, device=self.device),
            first=True,
        )

    def _ingest(self, frame: torch.Tensor) -> torch.Tensor:
        """Frame as carried: rounded uint8 with ``quantize_8bit``, else float32."""
        if not self.config.quantize_8bit:
            return frame.to(torch.float32)
        return quantize_u8(frame)

    def set_im_prev(self, state: FlowState, frame: torch.Tensor) -> FlowState:
        return FlowState(prev=self._ingest(frame), first=False)

    def _gate(self, shifts: torch.Tensor) -> torch.Tensor:
        """Validity gating -> NaN poisoning (``src/FftMethod.cpp:1840-1854``):
        reject ``|s|^2 > max_px^2``, ``|sx| > S/2``, ``|sy| > S/2``, NaN."""
        c = self.config
        sx, sy = shifts[..., 0], shifts[..., 1]
        ok = (sx * sx + sy * sy) <= c.max_pixel_speed * c.max_pixel_speed
        ok &= sx.abs() <= c.sample_point_size / 2.0
        ok &= sy.abs() <= c.sample_point_size / 2.0
        ok &= torch.isfinite(sx) & torch.isfinite(sy)
        return torch.where(ok[..., None], shifts, torch.full_like(shifts, float("nan")))

    def _correlate(self, curr: torch.Tensor, prev: torch.Tensor):
        """``[B, H, W]`` frame pairs -> ``(shift [B, P, 2], maxval [B, P])``
        on the configured route (module docstring)."""
        c = self.config
        if c.use_pallas and c.backend == "dft":
            return phase_correlate_frames(
                curr.contiguous(), prev.contiguous(),
                patch=c.sample_point_size,
                search_radius=c.search_radius,
                centroid_radius=c.centroid_radius,
            )
        raw = correlation_surface_raw(
            patchify(curr, c.sample_point_size), patchify(prev, c.sample_point_size),
            backend=c.backend,
        )
        peak = peak_refine_raw if c.use_pallas else peak_refine_raw_ref
        return peak(raw, search_radius=c.search_radius, centroid_radius=c.centroid_radius)

    def step(self, state: FlowState, frame: torch.Tensor) -> Tuple[FlowState, FlowResult]:
        """``FftMethod::processImage`` (``src/FftMethod.cpp:1772-1903``):
        grayscale ``[H, W]`` frame (uint8 or float) on the engine's device."""
        curr = self._ingest(frame)
        prev = curr if state.first else state.prev  # first-frame copy (:1788)
        raw, resp = self._correlate(curr[None], prev[None])
        raw, resp = raw[0], resp[0]
        result = FlowResult(shifts=self._gate(raw), shifts_raw=raw, response=resp)
        return FlowState(prev=curr, first=False), result  # imPrev swap (:1872)

    def step_batch(self, prev_frames: torch.Tensor, curr_frames: torch.Tensor) -> FlowResult:
        """Throughput mode: ``[B, H, W]`` frame pairs -> ``[B, P, 2]`` shifts."""
        raw, resp = self._correlate(self._ingest(curr_frames), self._ingest(prev_frames))
        return FlowResult(shifts=self._gate(raw), shifts_raw=raw, response=resp)

    def step_long_range(self, state: FlowState, frame: torch.Tensor):
        raise NotImplementedError("long-range mode is not ported yet (ROADMAP queue 1 item 7)")

    def step_batch_long_range(self, prev_frames: torch.Tensor, curr_frames: torch.Tensor):
        raise NotImplementedError("long-range mode is not ported yet (ROADMAP queue 1 item 7)")
