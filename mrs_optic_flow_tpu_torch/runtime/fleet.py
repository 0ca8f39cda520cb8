"""FleetServer — many camera streams, one batched dispatch per tick (port of
:mod:`mrs_optic_flow_tpu.runtime.fleet`).

``N`` UAV camera streams each carry their own previous-frame state (the
reference's ``imPrev`` swap, ``src/FftMethod.cpp:1872``, per stream), and
every tick runs the whole fleet's flow + geometry as one
:class:`~..parallel.pipeline.BatchPipeline` call.  The previous frames stay
on the card, preprocessed, so a tick uploads only the new frames (through
pinned memory, :class:`~.staging.HostStaging`) and reads nothing back until
the caller materializes it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from mrs_optic_flow_tpu_torch.convert import fleet_state_from_numpy
from mrs_optic_flow_tpu_torch.parallel.pipeline import BatchPipeline
from mrs_optic_flow_tpu_torch.runtime.serving import Draws
from mrs_optic_flow_tpu_torch.runtime.staging import HostStaging
from mrs_optic_flow_tpu_torch.utils.quat_np import np_quat_inverse, np_rpy_from_quat


@dataclasses.dataclass
class FleetTick:
    """One tick's results, still on the device: materialize lazily, so a
    caller can keep a tick in flight while it feeds the next."""

    ok: torch.Tensor  # [N] valid motion estimate this tick
    tran: torch.Tensor  # [N, 3] camera-frame velocity
    rot: torch.Tensor  # [N, 4] rate quaternion
    shifts: torch.Tensor  # [N, P, 2]
    dts: np.ndarray  # [N] per-stream frame spacing used
    #: per-stream log-polar (scale, rotation) when the server has a
    #: ScaleRotationEstimator (NaN where the tick is invalid)
    scale: Optional[torch.Tensor] = None  # [N]
    rotation: Optional[torch.Tensor] = None  # [N] rad

    def materialize(self) -> "FleetTick":
        def host(x):
            return None if x is None else x.cpu().numpy()

        return FleetTick(ok=host(self.ok), tran=host(self.tran), rot=host(self.rot),
                         shifts=host(self.shifts), dts=self.dts, scale=host(self.scale),
                         rotation=host(self.rotation))


class FleetServer:
    """Batched per-tick serving over ``n_streams`` stateful camera streams.

    ``tick(frames, stamps, heights, ...)`` consumes one frame per stream
    (``mask`` marks streams that produced no frame this tick: their state is
    carried, their output gated off) and returns a :class:`FleetTick`.  All
    streams share one camera->body rotation; use one server per camera
    mounting otherwise.  The server runs on its pipeline's device.
    """

    def __init__(
        self,
        pipeline: BatchPipeline,
        n_streams: int,
        *,
        c2b_quat=(0.0, 0.0, 0.0, 1.0),
        long_range: bool = False,
        cam_yaw: Optional[float] = None,
        seed: int = 0,
        scale_rotation=None,
        draws: Optional[Draws] = None,
    ):
        """``long_range=True`` runs the fleet through the downsampled
        long-range path (takeoff / low altitude); pass per-stream
        ``roll_rates``/``pitch_rates`` to :meth:`tick` for the rate
        feed-forward and ``rolls``/``pitches`` for the tilt correction.
        ``cam_yaw`` defaults to the node's ``yaw(inverse(c2b)) + pi/2``
        (``src/optic_flow.cpp:1206-1208``).

        ``scale_rotation``: an optional ``ScaleRotationEstimator`` (its
        ``resolution`` equal to the pipeline frame size), defaulting to the
        pipeline's own; every tick then estimates each stream's scale and
        rotation against its carried log-polar image.  When it is the
        pipeline's own estimator the short-range tick runs it inside
        :meth:`BatchPipeline.step_pre_carried`, otherwise as a second call.

        RANSAC draws come from a ``torch.Generator`` on the device seeded
        with ``seed``, or, with ``draws``, from ``draws(iterations, p, N)``
        once a short-range tick after the first."""
        self.pipeline = pipeline
        self.device = pipeline.device
        self.n = n_streams
        self.c2b = torch.tensor(c2b_quat, dtype=torch.float32).to(self.device)
        self.long_range = long_range
        if cam_yaw is None:
            # the identity mount maps to pi/2, which get2DT's rebuilt rate
            # feed-forward reads as mount yaw 0 (deviation 21)
            _, _, inv_yaw = np_rpy_from_quat(np_quat_inverse(np.asarray(c2b_quat, float)))
            cam_yaw = float(inv_yaw) + np.pi / 2
        self.cam_yaw = float(cam_yaw)
        if scale_rotation is None:
            scale_rotation = pipeline.scale_rotation
        if scale_rotation is not None and scale_rotation.config.resolution != pipeline.frame_size:
            raise ValueError("scale_rotation.resolution must equal the pipeline frame size")
        self.scale_rotation = scale_rotation
        #: the scale/rotation leg inside the pipeline call (short range only:
        #: the long-range fleet keeps the separate batched call)
        self._sr_fused = (scale_rotation is not None and pipeline.scale_rotation is scale_rotation
                          and not long_range)
        self.draws = draws
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._staging = HostStaging(self.device, slots=2)
        self._prev: Optional[torch.Tensor] = None  # [N, F, F] preprocessed, on the device
        self._prev_lp: Optional[torch.Tensor] = None  # [N, L, L] log-polar carry
        self._prev_stamps = np.zeros(n_streams)
        self._seen = np.zeros(n_streams, bool)

    def reset(self, stream_id: Optional[int] = None):
        """Drop carried state (all streams, or one), e.g. after a camera
        reconnect, so the next frame becomes a fresh first frame."""
        if stream_id is None:
            self._seen[:] = False
        else:
            self._seen[stream_id] = False

    def save_state(self, path: str):
        """Checkpoint the streaming state in the JAX fleet's ``.npz`` keys
        (``prev``, ``prev_lp``, ``prev_stamps``, ``seen``, ``long_range``),
        which that fleet can load too, plus this server's generator state
        as ``torch_rng`` (never ``key``).  ``path`` gets a ``.npz`` suffix
        if absent."""
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(
            path,
            prev=self._prev.cpu().numpy() if self._prev is not None else np.zeros(0),
            prev_lp=self._prev_lp.cpu().numpy() if self._prev_lp is not None else np.zeros(0),
            prev_stamps=self._prev_stamps,
            seen=self._seen,
            long_range=np.asarray(self.long_range),
            torch_rng=self._gen.get_state().numpy(),
        )

    def load_state(self, path: str):
        """Resume from a checkpoint written by either package's fleet, with
        the JAX fleet's validation errors (``convert.fleet_state_from_numpy``).
        A JAX checkpoint's RANSAC ``key`` is ignored (a threefry key has no
        torch equivalent): the generator keeps its state; a ``torch_rng``
        (the port's) is restored."""
        if not path.endswith(".npz"):
            path += ".npz"
        sr = self.scale_rotation
        with np.load(path) as z:
            st = fleet_state_from_numpy(z, self.device, n_streams=self.n, long_range=self.long_range,
                                        lp_res=sr.config.lp_res if sr is not None else None)
        self._prev = st.prev
        if st.prev_lp is not None:
            self._prev_lp = st.prev_lp
        self._prev_stamps = st.prev_stamps
        self._seen = st.seen
        if st.rng_state is not None:
            self._gen.set_state(st.rng_state)

    def _frames(self, frames) -> torch.Tensor:
        """Raw frames ``[N, ...]`` -> preprocessed ``[N, F, F]`` on the
        device, uploaded through pinned memory."""
        if isinstance(frames, torch.Tensor):
            frames = frames.to(self.device)
        else:
            frames = self._staging.array("frames", np.asarray(frames))
        if frames.shape[0] != self.n:
            raise ValueError(f"expected {self.n} streams, got {frames.shape[0]}")
        # preprocess ONCE per frame: this tick's curr and, where masked in,
        # the next tick's prev
        return self.pipeline.preprocess(frames)

    def tick(
        self,
        frames,
        stamps: np.ndarray,
        heights: np.ndarray,
        rate_quats: Optional[np.ndarray] = None,
        mask: Optional[np.ndarray] = None,
        roll_rates: Optional[np.ndarray] = None,
        pitch_rates: Optional[np.ndarray] = None,
        rolls: Optional[np.ndarray] = None,
        pitches: Optional[np.ndarray] = None,
    ) -> FleetTick:
        """``frames``: ``[N, H, W]`` (uint8 preferred: kernel A reads it as
        it is) or ``[N, H, W, 3]`` BGR.  ``stamps``/``heights``: ``[N]``.
        ``mask``: ``[N]`` bool, False = the stream produced no frame this
        tick.  ``rate_quats``: ``[N, 4]`` IMU rates (default identity).
        ``roll_rates``/``pitch_rates``: ``[N]``, long-range mode's rate
        feed-forward (default 0).  ``rolls``/``pitches``: ``[N]`` attitude
        angles [rad]; in long-range mode the heights are tilt-corrected
        ``h / (cos(pitch) cos(roll))`` before get2DT
        (``src/optic_flow.cpp:1780-1781``; default level)."""
        n = self.n
        frames = self._frames(frames)
        stamps = np.asarray(stamps, float)
        mask = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
        nan = math.nan

        if self._prev is None:
            # first tick: every frame is a first frame (the reference skips
            # it, src/optic_flow.cpp:1544-1547)
            self._prev = frames
            self._prev_stamps = stamps.copy()
            self._seen = mask.copy()
            sr_scale = sr_rot = None
            if self.scale_rotation is not None:
                self._prev_lp = self.scale_rotation.logpolar_batch(frames)
                sr_scale = torch.full((n,), nan, device=self.device)
                sr_rot = torch.full((n,), nan, device=self.device)
            eng = self.pipeline.engine
            p = eng.num_windows_lr if self.long_range else eng.num_windows
            rot = torch.zeros((n, 4), device=self.device)
            rot[:, 3] = 1.0
            return FleetTick(
                ok=torch.zeros((n,), dtype=torch.bool, device=self.device),
                tran=torch.full((n, 3), nan, device=self.device), rot=rot,
                shifts=torch.full((n, p, 2), nan, device=self.device), dts=np.zeros(n),
                scale=sr_scale, rotation=sr_rot,
            )

        dts = stamps - self._prev_stamps
        # negative/zero dt rejection (src/optic_flow.cpp:1425-1433), plus
        # first-frame and no-frame gating, all as data
        valid = mask & self._seen & (dts > 1e-3)
        safe_dts = np.where(dts > 1e-3, dts, 1.0)
        if rate_quats is None:
            rate_quats = np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1))
        heights = np.asarray(heights, np.float32)
        if self.long_range and (rolls is not None or pitches is not None):
            cr = np.cos(np.asarray(rolls, np.float32)) if rolls is not None else 1.0
            cp = np.cos(np.asarray(pitches, np.float32)) if pitches is not None else 1.0
            heights = heights / (cr * cp)
        zero = np.zeros(n, np.float32)
        # one upload of every per-stream number of the tick
        s = self._staging.array("scalars", np.stack([
            heights, safe_dts, *np.asarray(rate_quats, np.float32).T,
            zero if roll_rates is None else roll_rates, zero if pitch_rates is None else pitch_rates,
            valid, mask], axis=1).astype(np.float32))
        heights_d, dts_d, rates_d = s[:, 0], s[:, 1], s[:, 2:6]
        valid_d, mask_d = s[:, 8] > 0.5, s[:, 9] > 0.5

        if self.long_range:
            out = self.pipeline.step_long_range_pre(
                self._prev, frames, heights_d, dts_d, s[:, 6], s[:, 7], self.cam_yaw)
            # long range emits no rotation estimate (the reference publishes
            # NaN angulars on this topic, src/optic_flow.cpp:1839-1846)
            out_rot = torch.zeros((n, 4), device=self.device)
            out_rot[:, 3] = 1.0
        else:
            gumbel = None
            if self.draws is not None:
                p = self.pipeline.engine.num_windows
                gumbel = torch.as_tensor(self.draws(self.pipeline.ransac_iterations, p, n))
                gumbel = gumbel.to(device=self.device, dtype=torch.float32)
            if self.scale_rotation is not None and self._prev_lp is None:
                # e.g. resumed from a checkpoint without the log-polar carry
                self._prev_lp = self.scale_rotation.logpolar_batch(self._prev)
            step_kw = dict(gumbel=gumbel, generator=self._gen)
            if self._sr_fused:
                out, lp_c = self.pipeline.step_pre_carried(
                    self._prev, frames, self._prev_lp, heights_d, dts_d, rates_d, self.c2b, **step_kw)
            else:
                out = self.pipeline.step_pre(
                    self._prev, frames, heights_d, dts_d, rates_d, self.c2b, **step_kw)
            out_rot = out.rot

        sr_scale = sr_rot = None
        if self.scale_rotation is not None:
            if self._prev_lp is None:  # long-range first scale/rotation tick after a resume
                self._prev_lp = self.scale_rotation.logpolar_batch(self._prev)
            if self._sr_fused:
                sr_scale, sr_rot = out.scale, out.rotation
            else:
                lp_c, sr = self.scale_rotation.step_batch_carried(self._prev_lp, frames)
                sr_scale, sr_rot = sr.scale, sr.rotation
            sr_scale = torch.where(valid_d, sr_scale, nan)
            sr_rot = torch.where(valid_d, sr_rot, nan)
            self._prev_lp = torch.where(mask_d[:, None, None], lp_c, self._prev_lp)

        # carry: streams with a new frame swap prev, the others keep it
        self._prev = torch.where(mask_d[:, None, None], frames, self._prev)
        self._prev_stamps = np.where(mask, stamps, self._prev_stamps)
        self._seen = self._seen | mask

        return FleetTick(
            ok=out.ok & valid_d,
            tran=torch.where(valid_d[:, None], out.tran, nan),
            # invalid => NaN like tran: a first-frame, reconnected or dropped
            # stream's decomposition correlates unrelated frames
            rot=torch.where(valid_d[:, None], out_rot, nan),
            shifts=out.shifts,
            dts=dts,
            scale=sr_scale,
            rotation=sr_rot,
        )
