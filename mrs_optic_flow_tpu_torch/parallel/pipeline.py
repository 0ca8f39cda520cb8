"""BatchPipeline — the full per-frame step, batched (port of
:mod:`mrs_optic_flow_tpu.parallel.pipeline`).

Everything the reference does per frame (``processImage``,
``src/optic_flow.cpp:1541-1871``) over a batch of frame pairs on one card:
grayscale + crop -> the multi-patch phase correlation (kernel A, or kernel D
for a patch A cannot take) -> validity gating -> undistort -> RANSAC
homography -> decomposition -> IMU-consistent solution -> metric velocity,
optionally with the log-polar scale/rotation leg (kernel B).  Every step
issues its launches on the current stream and reads nothing back, so a
caller can keep several batches in flight (:class:`~..runtime.serving.
ServingLoop`).

The JAX package's ``mesh``/``axis_name`` shard the batch over TPU chips;
the port runs on one card and refuses a mesh.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mrs_optic_flow_tpu_torch.geometry.batched import get_rt_batch
from mrs_optic_flow_tpu_torch.geometry.motion import get_2dt_batch
from mrs_optic_flow_tpu_torch.models.fft_method import FftMethod, FftMethodConfig
from mrs_optic_flow_tpu_torch.ops.preprocess import center_crop, to_grayscale
from mrs_optic_flow_tpu_torch.utils.device import DEFAULT_DEVICE


#: the ``torch.profiler`` range around the batched getRT of every short-range step
GEOMETRY_RANGE = "get_rt_batch"


class PipelineOutput(NamedTuple):
    ok: torch.Tensor  # [B]
    tran: torch.Tensor  # [B, 3] camera-frame velocity
    rot: torch.Tensor  # [B, 4] rate quaternion
    shifts: torch.Tensor  # [B, P, 2]
    fleet_mean_speed: torch.Tensor  # [] NaN-ignoring mean |raw shift| over the batch
    #: per-pair log-polar scale factor / rotation [rad]: estimates when the
    #: pipeline has a ``scale_rotation`` estimator, NaN otherwise
    scale: torch.Tensor  # [B]
    rotation: torch.Tensor  # [B]


class LongRangeOutput(NamedTuple):
    ok: torch.Tensor  # [B]
    tran: torch.Tensor  # [B, 3] camera-frame velocity (z = 0)
    tran_diff: torch.Tensor  # [B, 3] rate-correction delta
    shifts: torch.Tensor  # [B, P_lr, 2]
    fleet_mean_speed: torch.Tensor  # []


class BatchPipeline:
    def __init__(
        self,
        *,
        frame_size: int = 480,
        sample_point_size: int = 120,
        camera_matrix: np.ndarray,
        dist_coeffs: np.ndarray,
        crop_cx: Optional[float] = None,
        shifted_pts_thr: int = 8,
        ransac_iterations: int = 256,
        backend: str = "dft",
        use_pallas: bool = True,
        half_spectrum: bool = True,
        bands_per_step: Optional[int] = None,
        mxu_passes: bool | int = True,
        mesh=None,
        axis_name: str = "data",
        scale_rotation=None,
        device=DEFAULT_DEVICE,
    ):
        """The JAX pipeline's arguments, on ``device`` (the card unless the
        caller names another).  ``half_spectrum``, ``bands_per_step`` and
        ``mxu_passes`` go to :class:`FftMethodConfig`, which ignores them;
        ``mesh`` must be None (``axis_name`` is then unused).

        ``scale_rotation``: an optional
        :class:`~mrs_optic_flow_tpu_torch.models.scale_rotation.ScaleRotationEstimator`
        on the same device, whose ``resolution`` equals the frame size.  With
        it :meth:`step`/:meth:`step_pre` also estimate each pair's scale and
        rotation (both frames resampled), and :meth:`step_pre_carried` takes
        the previous log-polar images as carried state (one resample per
        stream a tick, the fleet's shape).  Match:
        ``src/scaleRotationEstimator.cpp:34-148``."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh: the port runs on one card; the JAX package's batch sharding is not ported")
        self.engine = FftMethod(
            FftMethodConfig(
                frame_size=frame_size,
                sample_point_size=sample_point_size,
                backend=backend,
                use_pallas=use_pallas,
                half_spectrum=half_spectrum,
                bands_per_step=bands_per_step,
                mxu_passes=mxu_passes,
            ),
            device=device,
        )
        self.device = self.engine.device
        # the engine-normalized geometry, not the raw arguments: the engine
        # forces an even frame and patch | frame (FftMethodConfig.normalized),
        # and the geometry's patch grid must be the one the shifts come on
        self.frame_size = self.engine.config.frame_size
        self.sample_point_size = self.engine.config.sample_point_size
        self.camera_matrix = np.asarray(camera_matrix, np.float32)
        self.dist_coeffs = np.asarray(dist_coeffs, np.float32)
        self.crop_cx = float(crop_cx if crop_cx is not None else camera_matrix[0, 2])
        self.ul_x = float(int(self.crop_cx) - self.frame_size // 2)
        self.shifted_pts_thr = shifted_pts_thr
        self.ransac_iterations = ransac_iterations
        if scale_rotation is not None:
            if scale_rotation.config.resolution != self.frame_size:
                raise ValueError("scale_rotation.resolution must equal the pipeline frame size")
            if scale_rotation.device != self.device:
                raise ValueError(f"scale_rotation runs on {scale_rotation.device}, the pipeline "
                                 f"on {self.device}")
        self.scale_rotation = scale_rotation
        self._cam = torch.from_numpy(self.camera_matrix).to(self.device)
        # a distortion-free camera skips the undistortion iterations
        self._dist = (torch.from_numpy(self.dist_coeffs).to(self.device)
                      if np.any(self.dist_coeffs) else None)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        """``x`` on the pipeline's device; a device tensor of that dtype as
        it is (no copy)."""
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    def preprocess(self, raw) -> torch.Tensor:
        """Raw ``[B, H, W]`` gray or ``[B, H, W, 3]`` BGR frames -> the
        ``[B, F, F]`` centre crops, contiguous.  Gray frames keep their dtype
        (uint8 goes to the kernel as it is); BGR becomes float32 gray."""
        raw = raw if isinstance(raw, torch.Tensor) else torch.as_tensor(np.asarray(raw))
        raw = raw.to(self.device)
        g = to_grayscale(raw) if raw.ndim == 4 else raw
        return center_crop(g, self.frame_size, int(self.crop_cx)).contiguous()

    def logpolar_carry(self, frames: torch.Tensor) -> torch.Tensor:
        """The log-polar images of preprocessed frames: the initial (or
        rebuilt) carry of :meth:`step_pre_carried`."""
        if self.scale_rotation is None:
            raise ValueError("logpolar_carry needs a pipeline built with scale_rotation")
        return self.scale_rotation.logpolar_batch(frames)

    def _core(self, prev, curr, heights, dts, rate_quats, c2b, gumbel, generator, sr_pair):
        res = self.engine.step_batch(prev, curr)
        # a profiler range: a trace attributes the geometry's kernels to it
        with torch.profiler.record_function(GEOMETRY_RANGE):
            rt = get_rt_batch(
                res.shifts, self._tensor(heights), self._tensor(dts), self.ul_x, self._cam,
                self._dist, self._tensor(c2b), self._tensor(rate_quats),
                frame_size=self.frame_size,
                patch=self.sample_point_size,
                shifted_pts_thr=self.shifted_pts_thr,
                ransac_iterations=self.ransac_iterations,
                gumbel=gumbel,
                generator=generator,
            )
        # fleet statistic: nanmean, so one dead stream's NaN raw shifts do
        # not blind it
        fleet = torch.nanmean(torch.linalg.norm(res.shifts_raw, dim=-1))
        scale, rotation = sr_pair
        if scale is None:
            b = res.shifts.shape[0]
            scale = torch.full((b,), math.nan, device=self.device)
            rotation = torch.full((b,), math.nan, device=self.device)
        return PipelineOutput(
            ok=rt.ok, tran=rt.tran, rot=rt.rot, shifts=res.shifts,
            fleet_mean_speed=fleet, scale=scale, rotation=rotation,
        )

    def _step(self, prev, curr, heights, dts, rate_quats, c2b, gumbel, generator) -> PipelineOutput:
        sr_pair = (None, None)
        if self.scale_rotation is not None:
            # stateless pairs: both frames resampled
            res = self.scale_rotation.step_batch(prev, curr)
            sr_pair = (res.scale, res.rotation)
        return self._core(prev, curr, heights, dts, rate_quats, c2b, gumbel, generator, sr_pair)

    def step(self, prev_raw, curr_raw, heights, dts, rate_quats, c2b, *,
             gumbel: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> PipelineOutput:
        """Raw ``[B, H, W]`` or ``[B, H, W, 3]`` frame pairs, heights and
        dts ``[B]``, IMU rate quaternions ``[B, 4]`` and the camera->body
        quaternion ``[4]`` -> :class:`PipelineOutput`.  ``gumbel``
        ``[ransac_iterations, P, B]`` gives the RANSAC draws; without it they
        come from ``generator`` (:func:`~..geometry.batched.get_rt_batch`)."""
        return self._step(self.preprocess(prev_raw), self.preprocess(curr_raw), heights, dts,
                          rate_quats, c2b, gumbel, generator)

    def step_pre(self, prev, curr, heights, dts, rate_quats, c2b, *,
                 gumbel: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> PipelineOutput:
        """:meth:`step` on already preprocessed ``[B, F, F]`` frames (a
        fleet carries the preprocessed previous frame)."""
        return self._step(prev, curr, heights, dts, rate_quats, c2b, gumbel, generator)

    def step_pre_carried(self, prev, curr, prev_lp, heights, dts, rate_quats, c2b, *,
                         gumbel: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        """:meth:`step_pre` with the scale/rotation leg on carried log-polar
        images: ``prev_lp`` ``[B, L, L]`` (the previous frames' log-polar
        images) -> ``(PipelineOutput, curr_lp)``, ``curr_lp`` the next
        call's ``prev_lp``."""
        if self.scale_rotation is None:
            raise ValueError("step_pre_carried needs a pipeline built with scale_rotation")
        lp_c, res = self.scale_rotation.step_batch_carried(prev_lp, curr)
        out = self._core(prev, curr, heights, dts, rate_quats, c2b, gumbel, generator,
                         (res.scale, res.rotation))
        return out, lp_c

    def _step_long_range(self, prev, curr, heights, dts, roll_rates, pitch_rates, cam_yaw):
        res = self.engine.step_batch_long_range(prev, curr)
        rt = get_2dt_batch(
            res.shifts, self._tensor(heights), self._tensor(dts), self._cam,
            self._tensor(roll_rates), self._tensor(pitch_rates), float(cam_yaw),
            long_range_ratio=self.engine.config.long_range_ratio,
        )
        fleet = torch.nanmean(torch.linalg.norm(res.shifts_raw, dim=-1))
        return LongRangeOutput(ok=rt.ok, tran=rt.tran, tran_diff=rt.tran_diff,
                               shifts=res.shifts, fleet_mean_speed=fleet)

    def step_long_range(self, prev_raw, curr_raw, heights, dts, roll_rates, pitch_rates,
                        cam_yaw: float) -> LongRangeOutput:
        """Batched long-range mode: frames downsampled by
        ``long_range_ratio``, the coarse window grid, then get2DT pair by
        pair with the roll/pitch-rate feed-forward.  ``heights`` must be
        tilt-corrected by the caller, ``h / (cos(pitch) cos(roll))``
        (``src/optic_flow.cpp:1780-1781``); ``cam_yaw`` is the mount yaw
        (a number)."""
        return self._step_long_range(self.preprocess(prev_raw), self.preprocess(curr_raw),
                                     heights, dts, roll_rates, pitch_rates, cam_yaw)

    def step_long_range_pre(self, prev, curr, heights, dts, roll_rates, pitch_rates,
                            cam_yaw: float) -> LongRangeOutput:
        """:meth:`step_long_range` on already preprocessed frames."""
        return self._step_long_range(prev, curr, heights, dts, roll_rates, pitch_rates, cam_yaw)
