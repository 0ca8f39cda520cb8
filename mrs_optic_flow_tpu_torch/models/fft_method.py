"""FftMethod — the live flow engine (method 4 of the reference).

Port of :mod:`mrs_optic_flow_tpu.models.fft_method`: a grid of
``sqNum x sqNum`` phase correlations per frame pair with validity gating
(``src/FftMethod.cpp:1680-1903``), and the long-range variant on frames
downsampled by ``long_range_ratio`` (``:1905-2007``).  The routes follow the
JAX engine's ``_correlate``:

- ``use_pallas=True, backend="dft"``: the whole-frame kernel A,
  :func:`~mrs_optic_flow_tpu_torch.ops.cuda_kernels.phase_correlate_frames`,
  for a patch that is a multiple of 8 (the JAX engine's rule) and within
  A's shared memory
  (:func:`~mrs_optic_flow_tpu_torch.ops.cuda_kernels.frames_kernel_takes`);
  for every other patch, patchify and the patch-batch kernel D,
  :func:`~mrs_optic_flow_tpu_torch.ops.cuda_kernels.phase_correlate_fullfused`;
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
    frames_kernel_takes,
    peak_refine_raw,
    peak_refine_raw_ref,
    phase_correlate_frames,
    phase_correlate_fullfused,
)
from mrs_optic_flow_tpu_torch.ops.phase_correlate import (
    DEFAULT_CENTROID_RADIUS,
    DEFAULT_SEARCH_RADIUS,
    correlation_surface_raw,
)
from mrs_optic_flow_tpu_torch.ops.preprocess import patchify, quantize_u8, resize_by
from mrs_optic_flow_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


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

    def __init__(self, config: FftMethodConfig = FftMethodConfig(), *, device=DEFAULT_DEVICE):
        self.config = config.normalized()
        c = self.config
        self.device = resolve_device(device)
        #: grid side (sqNum, src/FftMethod.cpp:1719)
        self.sq_num = c.frame_size // c.sample_point_size
        self.num_windows = self.sq_num * self.sq_num
        #: long-range patch and grid side (sqNum_lr, :1720): the patch stays
        #: the normal one (:1685) unless the downsampled frame is smaller, where
        #: the whole downsampled frame is the one window (frame 360, patch
        #: 120, ratio 4 -> 90 px; ARCHITECTURE.md deviation 5)
        self.patch_lr = min(c.sample_point_size, c.frame_size // c.long_range_ratio)
        self.sq_num_lr = max((c.frame_size // c.long_range_ratio) // self.patch_lr, 1)
        self.num_windows_lr = self.sq_num_lr * self.sq_num_lr

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

    def _gate(self, shifts: torch.Tensor, patch: int) -> torch.Tensor:
        """Validity gating -> NaN poisoning (``src/FftMethod.cpp:1840-1854``):
        reject ``|s|^2 > max_px^2``, ``|sx| > S/2``, ``|sy| > S/2``, NaN;
        the long-range bounds are the same with its patch (``:1687``)."""
        c = self.config
        sx, sy = shifts[..., 0], shifts[..., 1]
        ok = (sx * sx + sy * sy) <= c.max_pixel_speed * c.max_pixel_speed
        ok &= sx.abs() <= patch / 2.0
        ok &= sy.abs() <= patch / 2.0
        ok &= torch.isfinite(sx) & torch.isfinite(sy)
        return torch.where(ok[..., None], shifts, torch.full_like(shifts, float("nan")))

    def _correlate(self, curr: torch.Tensor, prev: torch.Tensor, patch: int):
        """``[B, H, W]`` frame pairs (H = W = q * patch) -> ``(shift [B, q*q,
        2], maxval [B, q*q])`` on the configured route (module docstring)."""
        c = self.config
        radii = dict(search_radius=c.search_radius, centroid_radius=c.centroid_radius)
        if c.use_pallas and c.backend == "dft" and frames_kernel_takes(patch):
            return phase_correlate_frames(curr.contiguous(), prev.contiguous(), patch=patch, **radii)
        curr_p, prev_p = patchify(curr, patch), patchify(prev, patch)
        if c.use_pallas and c.backend == "dft":
            b, q2 = curr_p.shape[:2]
            shift, maxval = phase_correlate_fullfused(
                curr_p.reshape(b * q2, patch, patch).contiguous(),
                prev_p.reshape(b * q2, patch, patch).contiguous(), **radii,
            )
            return shift.reshape(b, q2, 2), maxval.reshape(b, q2)
        raw = correlation_surface_raw(curr_p, prev_p, backend=c.backend)
        peak = peak_refine_raw if c.use_pallas else peak_refine_raw_ref
        return peak(raw, **radii)

    def _lr_correlate(self, curr_d: torch.Tensor, prev_d: torch.Tensor):
        """Downsampled ``[B, h, w]`` frame pairs -> raw long-range shifts
        and responses, after trimming to the ``sq_num_lr * patch_lr`` window
        grid, top-left aligned like the reference's Rect windows
        (``src/FftMethod.cpp:1945-1957``): frame 600, patch 120, ratio 4 ->
        a 150 px image and one 120 px window."""
        m = self.sq_num_lr * self.patch_lr
        return self._correlate(curr_d[..., :m, :m], prev_d[..., :m, :m], self.patch_lr)

    def _downsample(self, frames: torch.Tensor) -> torch.Tensor:
        """The long-range frames: bilinear resize by ``long_range_ratio``
        (antialiased like the JAX engine's, fault F1) in float32; the result
        is no longer 8-bit exact, so it stays float32."""
        return resize_by(frames.to(torch.float32), self.config.long_range_ratio)

    def step(self, state: FlowState, frame: torch.Tensor) -> Tuple[FlowState, FlowResult]:
        """``FftMethod::processImage`` (``src/FftMethod.cpp:1772-1903``):
        grayscale ``[H, W]`` frame (uint8 or float) on the engine's device."""
        curr = self._ingest(frame)
        prev = curr if state.first else state.prev  # first-frame copy (:1788)
        raw, resp = self._correlate(curr[None], prev[None], self.config.sample_point_size)
        raw, resp = raw[0], resp[0]
        result = FlowResult(shifts=self._gate(raw, self.config.sample_point_size),
                            shifts_raw=raw, response=resp)
        return FlowState(prev=curr, first=False), result  # imPrev swap (:1872)

    def step_long_range(self, state: FlowState, frame: torch.Tensor) -> Tuple[FlowState, FlowResult]:
        """``processImageLongRange`` (``src/FftMethod.cpp:1905-2007``): both
        frames downsampled by ``long_range_ratio`` (``:1931-1932``), the
        coarser ``sq_num_lr`` grid of ``patch_lr`` windows, the same gating
        with the long-range patch.  The carry is the full-resolution frame,
        as in :meth:`step`, so the node can switch modes between frames."""
        curr = self._ingest(frame)
        prev = curr if state.first else state.prev
        raw, resp = self._lr_correlate(self._downsample(curr)[None], self._downsample(prev)[None])
        raw, resp = raw[0], resp[0]
        result = FlowResult(shifts=self._gate(raw, self.patch_lr), shifts_raw=raw, response=resp)
        return FlowState(prev=curr, first=False), result

    def step_batch(self, prev_frames: torch.Tensor, curr_frames: torch.Tensor) -> FlowResult:
        """Throughput mode: ``[B, H, W]`` frame pairs -> ``[B, P, 2]`` shifts."""
        patch = self.config.sample_point_size
        raw, resp = self._correlate(self._ingest(curr_frames), self._ingest(prev_frames), patch)
        return FlowResult(shifts=self._gate(raw, patch), shifts_raw=raw, response=resp)

    def step_batch_long_range(self, prev_frames: torch.Tensor, curr_frames: torch.Tensor) -> FlowResult:
        """Batched long-range mode: ``[B, H, W]`` frame pairs ->
        ``[B, num_windows_lr, 2]`` shifts, as :meth:`step_long_range` pair by
        pair."""
        raw, resp = self._lr_correlate(
            self._downsample(self._ingest(curr_frames)), self._downsample(self._ingest(prev_frames)),
        )
        return FlowResult(shifts=self._gate(raw, self.patch_lr), shifts_raw=raw, response=resp)
