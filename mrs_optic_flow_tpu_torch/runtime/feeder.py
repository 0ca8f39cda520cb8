"""Native camera feeder: capture thread -> lock-free queue -> node.

The port's own copy of :mod:`mrs_optic_flow_tpu.runtime.feeder`, on the
port's native binding and node.  The reference serializes everything on one blocking
OpenCL enqueue guarded by a ``running`` flag and a process mutex
(``src/FftMethod.cpp:1775-1777``, ``src/optic_flow.cpp:1683``), so a slow
frame stalls capture.  Here the capture side pushes raw BGR frames into the
native SPSC ring buffer and never blocks; the feed side drains to the
*newest* frame (real-time semantics — stale frames are counted, not
processed), preprocesses with the fused native uint8 gray+crop, and drives
the node.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from mrs_optic_flow_tpu_torch import native
from mrs_optic_flow_tpu_torch.runtime.msgs import ImageMsg
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode


class NativeFeeder:
    def __init__(
        self,
        node: OpticFlowNode,
        *,
        width: int,
        height: int,
        capacity: int = 8,
        realtime: bool = True,
        swap_rb: bool = True,
    ):
        self.node = node
        self.width = width
        self.height = height
        self.realtime = realtime
        self.swap_rb = swap_rb
        # the fused native gray+crop has no resize stage: with a scale
        # factor the node expects a downscaled frame cropped at the SCALED
        # principal point, and the feeder's full-resolution crop would be
        # silently accepted by the node's pre-cropped fast path with the
        # wrong FOV — fail loudly instead (feed raw frames to the node's
        # own on-device resize path in that configuration)
        if abs(node.config.scale_factor - 1.0) > 0.01:
            raise ValueError(
                "NativeFeeder does not support scale_factor != 1 "
                f"(got {node.config.scale_factor}); feed raw frames to "
                "OpticFlowNode.on_image instead"
            )
        self.queue = native.FrameQueue(capacity, (height, width, 3))
        self.frames_fed = 0
        self.frames_skipped = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- capture side (producer; never blocks) --

    def push(self, frame_bgr: np.ndarray, stamp: float) -> bool:
        """Enqueue a raw BGR frame; False means the ring was full (dropped)."""
        return self.queue.push(frame_bgr, stamp)

    @property
    def dropped(self) -> int:
        return self.queue.dropped

    # -- feed side (consumer) --

    def _preprocess(self, frame: np.ndarray) -> np.ndarray:
        cam = self.node.camera_matrix
        cx = int(cam[0, 2]) if cam is not None else self.width // 2
        size = self.node.config.frame_size
        # the native crop clamps its origin into bounds, but the node's
        # geometry uses the UNCLAMPED ul_x = cx - size/2: if the window
        # doesn't fit as-is the two silently disagree and every grid
        # coordinate is biased — fail loudly like the device path would
        x0 = cx - size // 2
        y0 = self.height // 2 - size // 2
        if x0 < 0 or x0 + size > self.width or y0 < 0 or y0 + size > self.height:
            raise ValueError(
                f"frame_size {size} crop at cx={cx} does not fit the "
                f"{self.width}x{self.height} capture; the clamped native "
                "crop would disagree with the node's crop geometry"
            )
        return native.gray_crop(
            frame, cx=cx, cy=self.height // 2, size=size, swap_rb=self.swap_rb,
        )

    def feed_once(self) -> bool:
        """Pop (latest if realtime) + preprocess + drive the node once."""
        if self.realtime:
            item = self.queue.pop_latest()
            if item is None:
                return False
            frame, stamp, skipped = item
            self.frames_skipped += skipped
        else:
            item = self.queue.pop()
            if item is None:
                return False
            frame, stamp = item
        gray = self._preprocess(frame)
        self.node.on_image(ImageMsg(stamp=stamp, data=gray))
        self.frames_fed += 1
        return True

    def run(self, poll_interval_s: float = 0.0005):
        """Feed loop until :meth:`stop`; run in a dedicated thread."""
        while not self._stop.is_set():
            if not self.feed_once():
                self._stop.wait(poll_interval_s)

    def start(self) -> "NativeFeeder":
        # non-daemon: a thread abandoned inside a device call at interpreter
        # exit can abort the process; stop() joins without timeout
        self._thread = threading.Thread(target=self.run, daemon=False)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
