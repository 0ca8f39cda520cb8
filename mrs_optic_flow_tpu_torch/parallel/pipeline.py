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

With a ``mesh`` (:func:`~.sharding.make_mesh`) every step splits the batch
over the mesh's shards and runs the chain once a shard on its device, then
gathers the results onto the mesh's first device.  The RANSAC draws are
made once for the whole batch and sliced, so a sharded step equals the
unsharded one with the same generator.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mrs_optic_flow_tpu_torch.geometry.batched import draw_gumbel, get_rt_batch
from mrs_optic_flow_tpu_torch.geometry.motion import get_2dt_batch
from mrs_optic_flow_tpu_torch.models.fft_method import FftMethod, FftMethodConfig
from mrs_optic_flow_tpu_torch.ops.preprocess import center_crop, to_grayscale
from mrs_optic_flow_tpu_torch.parallel.sharding import Mesh, Sharded, gather, scatter
from mrs_optic_flow_tpu_torch.utils.device import DEFAULT_DEVICE, same_device


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
        mesh: Optional[Mesh] = None,
        axis_name: str = "data",
        scale_rotation=None,
        device=DEFAULT_DEVICE,
    ):
        """The JAX pipeline's arguments, on ``device`` (the card unless the
        caller names another).  ``half_spectrum``, ``bands_per_step`` and
        ``mxu_passes`` go to :class:`FftMethodConfig`, which ignores them.

        ``mesh``: a :class:`~.sharding.Mesh` to shard every step's batch
        over (B must divide evenly); the pipeline then runs on the mesh's
        first device, where inputs that are not sharded are scattered from
        and every output is gathered, and ``device`` must be of its type.
        ``axis_name`` names the mesh axis, as in the JAX pipeline.

        ``scale_rotation``: an optional
        :class:`~mrs_optic_flow_tpu_torch.models.scale_rotation.ScaleRotationEstimator`
        on the same device, whose ``resolution`` equals the frame size.  With
        it :meth:`step`/:meth:`step_pre` also estimate each pair's scale and
        rotation (both frames resampled), and :meth:`step_pre_carried` takes
        the previous log-polar images as carried state (one resample per
        stream a tick, the fleet's shape).  Match:
        ``src/scaleRotationEstimator.cpp:34-148``."""
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.sharding.Mesh (make_mesh), got {mesh!r}")
            if torch.device(device).type != mesh.first.type:
                raise ValueError(f"device {device!r} and a mesh on {mesh.first}")
            device = mesh.first
        self.mesh = mesh
        self.axis_name = axis_name
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
            if not same_device(scale_rotation.device, self.device):
                raise ValueError(f"scale_rotation runs on {scale_rotation.device}, the pipeline "
                                 f"on {self.device}")
        self.scale_rotation = scale_rotation
        self._cam = torch.from_numpy(self.camera_matrix).to(self.device)
        # a distortion-free camera skips the undistortion iterations
        self._dist = (torch.from_numpy(self.dist_coeffs).to(self.device)
                      if np.any(self.dist_coeffs) else None)
        #: the shards every step runs on: the mesh's, or the pipeline's device
        self._shards = mesh if mesh is not None else Mesh([self.device])
        #: the camera constants on each shard's device, made once
        self._consts = {self.device: (self._cam, self._dist)}

    def _camera_on(self, device: torch.device):
        """``(camera matrix, distortion or None)`` on ``device``."""
        if device not in self._consts:
            self._consts[device] = (self._cam.to(device),
                                    None if self._dist is None else self._dist.to(device))
        return self._consts[device]

    def _preprocess_on(self, raw, device) -> torch.Tensor:
        raw = raw if isinstance(raw, torch.Tensor) else torch.as_tensor(np.asarray(raw))
        raw = raw.to(device)
        g = to_grayscale(raw) if raw.ndim == 4 else raw
        return center_crop(g, self.frame_size, int(self.crop_cx)).contiguous()

    def preprocess(self, raw):
        """Raw ``[B, H, W]`` gray or ``[B, H, W, 3]`` BGR frames -> the
        ``[B, F, F]`` centre crops, contiguous.  Gray frames keep their dtype
        (uint8 goes to the kernel as it is); BGR becomes float32 gray.  A
        :class:`~.sharding.Sharded` batch is cropped shard by shard on its
        devices and stays sharded."""
        if isinstance(raw, Sharded):
            return Sharded([self._preprocess_on(r, r.device) for r in raw.shards], raw.mesh)
        return self._preprocess_on(raw, self.device)

    def preprocess_crops(self, crops: torch.Tensor) -> torch.Tensor:
        """:meth:`preprocess` of frames already cut to the crop, ``[B, F, F]``
        gray or ``[B, F, F, 3]`` BGR on the pipeline's device: the same grey
        of the same pixels, converted on the crop alone."""
        if tuple(crops.shape[1:3]) != (self.frame_size, self.frame_size):
            raise ValueError(f"crops of {tuple(crops.shape[1:3])} px, the pipeline crops {self.frame_size}")
        return (to_grayscale(crops) if crops.ndim == 4 else crops).contiguous()

    def logpolar_carry(self, frames: torch.Tensor) -> torch.Tensor:
        """The log-polar images of preprocessed frames: the initial (or
        rebuilt) carry of :meth:`step_pre_carried`."""
        if self.scale_rotation is None:
            raise ValueError("logpolar_carry needs a pipeline built with scale_rotation")
        return self.scale_rotation.logpolar_batch(frames)

    def _gumbel(self, gumbel, generator, b: int) -> torch.Tensor:
        """The whole batch's RANSAC draws ``[I, P, B]``: ``gumbel`` as
        given, or drawn once from ``generator`` on the pipeline's device."""
        shape = (self.ransac_iterations, self.engine.num_windows, b)
        if gumbel is None:
            return draw_gumbel(*shape, self.device, generator)
        if tuple(gumbel.shape) != shape:
            raise ValueError(f"gumbel has shape {tuple(gumbel.shape)}, expected {shape}")
        return gumbel

    def _run(self, prev, curr, heights, dts, rate_quats, c2b, gumbel, generator, sr_mode=None,
             prev_lp=None):
        """The chain once a shard, gathered on the first shard's device.
        ``sr_mode``: None, ``"pairs"`` (both frames resampled) or
        ``"carried"`` (``prev_lp`` carried).  Returns ``(PipelineOutput,
        curr_lp or None)``."""
        shards = self._shards
        prevs, currs = scatter(prev, shards), scatter(curr, shards)
        hs, ds = scatter(heights, shards, torch.float32), scatter(dts, shards, torch.float32)
        rs = scatter(rate_quats, shards, torch.float32)
        lps = scatter(prev_lp, shards) if sr_mode == "carried" else [None] * shards.size
        b = sum(p.shape[0] for p in prevs)
        k = b // shards.size
        outs, speeds, lp_cs = [], [], []
        for i, dev in enumerate(shards.devices):
            scale = rotation = None
            if sr_mode == "pairs":
                res = self.scale_rotation.step_batch(prevs[i], currs[i])
                scale, rotation = res.scale, res.rotation
            elif sr_mode == "carried":
                lp_c, res = self.scale_rotation.step_batch_carried(lps[i], currs[i])
                lp_cs.append(lp_c)
                scale, rotation = res.scale, res.rotation
            cam, dist = self._camera_on(dev)
            flow = self.engine.step_batch(prevs[i], currs[i])
            # a profiler range: a trace attributes the geometry's kernels to it
            with torch.profiler.record_function(GEOMETRY_RANGE):
                if i == 0:  # the whole batch's draws, made once
                    gumbel = self._gumbel(gumbel, generator, b)
                rt = get_rt_batch(
                    flow.shifts, hs[i], ds[i], self.ul_x, cam, dist,
                    torch.as_tensor(c2b, dtype=torch.float32).to(dev), rs[i],
                    frame_size=self.frame_size,
                    patch=self.sample_point_size,
                    shifted_pts_thr=self.shifted_pts_thr,
                    ransac_iterations=self.ransac_iterations,
                    gumbel=gumbel[..., i * k:(i + 1) * k].to(dev),
                )
            if scale is None:
                scale = torch.full((k,), math.nan, device=dev)
                rotation = torch.full((k,), math.nan, device=dev)
            outs.append((rt.ok, rt.tran, rt.rot, flow.shifts, scale, rotation))
            speeds.append(torch.linalg.norm(flow.shifts_raw, dim=-1))
        ok, tran, rot, shifts, scale, rotation = (gather(parts, shards) for parts in zip(*outs))
        # fleet statistic: nanmean over the whole batch, so one dead stream's
        # NaN raw shifts do not blind it
        out = PipelineOutput(ok=ok, tran=tran, rot=rot, shifts=shifts,
                             fleet_mean_speed=torch.nanmean(gather(speeds, shards)),
                             scale=scale, rotation=rotation)
        return out, (gather(lp_cs, shards) if lp_cs else None)

    def _step(self, prev, curr, heights, dts, rate_quats, c2b, gumbel, generator) -> PipelineOutput:
        sr_mode = "pairs" if self.scale_rotation is not None else None
        return self._run(prev, curr, heights, dts, rate_quats, c2b, gumbel, generator, sr_mode)[0]

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
        return self._run(prev, curr, heights, dts, rate_quats, c2b, gumbel, generator, "carried",
                         prev_lp)

    def _step_long_range(self, prev, curr, heights, dts, roll_rates, pitch_rates, cam_yaw):
        shards = self._shards
        parts = [scatter(prev, shards), scatter(curr, shards)]
        parts += [scatter(x, shards, torch.float32) for x in (heights, dts, roll_rates, pitch_rates)]
        outs, speeds = [], []
        for i, dev in enumerate(shards.devices):
            p, c, h, d, rr, pr = (x[i] for x in parts)
            flow = self.engine.step_batch_long_range(p, c)
            rt = get_2dt_batch(flow.shifts, h, d, self._camera_on(dev)[0], rr, pr, float(cam_yaw),
                               long_range_ratio=self.engine.config.long_range_ratio)
            outs.append((rt.ok, rt.tran, rt.tran_diff, flow.shifts))
            speeds.append(torch.linalg.norm(flow.shifts_raw, dim=-1))
        ok, tran, tran_diff, shifts = (gather(x, shards) for x in zip(*outs))
        return LongRangeOutput(ok=ok, tran=tran, tran_diff=tran_diff, shifts=shifts,
                               fleet_mean_speed=torch.nanmean(gather(speeds, shards)))

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
