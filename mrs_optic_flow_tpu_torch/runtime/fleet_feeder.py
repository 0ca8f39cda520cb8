"""FleetFeeder — N native capture queues feeding one FleetServer (port of
:mod:`mrs_optic_flow_tpu.runtime.fleet_feeder`).

Each camera stream pushes raw frames into its own lock-free native ring
(capture never blocks), and each tick drains every ring to its newest frame
in one native call, assembles the ``[N, H, W]`` batch and presence mask, and
dispatches one :meth:`FleetServer.tick`.  Streams whose ring is empty this
tick carry their state (masked out); stale frames are skipped and counted.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from mrs_optic_flow_tpu_torch import native
from mrs_optic_flow_tpu_torch.runtime.fleet import FleetServer, FleetTick


class FleetFeeder:
    def __init__(
        self,
        fleet: FleetServer,
        *,
        frame_shape: Tuple[int, ...],
        capacity: int = 8,
        dtype=np.uint8,
    ):
        """``frame_shape``: per-stream raw frame shape, ``(H, W)`` grayscale
        or ``(H, W, 3)`` BGR (the fleet's pipeline preprocesses either)."""
        self.fleet = fleet
        self.frame_shape = tuple(frame_shape)
        self.queues = [native.FrameQueue(capacity, self.frame_shape, dtype=dtype) for _ in range(fleet.n)]
        self.frames_skipped = 0
        #: last frame per stream, reused when a stream produced nothing this
        #: tick (the tick takes a full [N, ...] array; masked-out slots are
        #: ignored by the fleet)
        self._last = np.zeros((fleet.n,) + self.frame_shape, dtype)
        self._last_stamps = np.zeros(fleet.n)

    def push(self, stream_id: int, frame: np.ndarray, stamp: float) -> bool:
        """Capture side for stream ``stream_id``; never blocks.  False means
        that ring was full (frame dropped, counted in :attr:`dropped`)."""
        return self.queues[stream_id].push(frame, stamp)

    @property
    def dropped(self) -> int:
        return sum(q.dropped for q in self.queues)

    def tick(
        self,
        heights: Sequence[float],
        rate_quats: Optional[np.ndarray] = None,
        roll_rates: Optional[np.ndarray] = None,
        pitch_rates: Optional[np.ndarray] = None,
    ) -> Optional[FleetTick]:
        """Drain every ring to its newest frame and dispatch one fleet tick;
        None when no stream produced a frame."""
        n = self.fleet.n
        mask_u8 = np.zeros(n, np.uint8)
        stamps = np.zeros(n, np.float64)
        self.frames_skipped += native.gather_latest(self.queues, self._last, stamps, mask_u8)
        mask = mask_u8.astype(bool)
        if not mask.any():
            return None
        self._last_stamps = np.where(mask, stamps, self._last_stamps)
        return self.fleet.tick(
            self._last,
            self._last_stamps,
            np.asarray(heights, float),
            rate_quats=rate_quats,
            mask=mask,
            roll_rates=roll_rates,
            pitch_rates=pitch_rates,
        )
