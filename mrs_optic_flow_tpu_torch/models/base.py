"""Abstract flow-engine interface — the ``OpticFlowCalc`` contract
(``include/OpticFlowCalc.h:6-22``), port of :mod:`mrs_optic_flow_tpu.models.base`.

Gray frame in, per-window pixel shifts out, invalid windows poisoned with
NaN; state is explicit: state in, state out.  :class:`OpticFlowCalc` wraps
an engine in the reference's stateful interface.
"""

from __future__ import annotations

import abc
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class FlowState(NamedTuple):
    """Per-stream engine state.

    ``prev`` — previous grayscale frame ``[H, W]`` on the engine's device
    (the reference's ``imPrev``), uint8 when the engine carries the 8-bit
    pipeline, float32 otherwise.  ``first`` — host bool: on the first frame
    the current frame is copied into ``imPrev`` so the first output is a
    zero-shift measurement (``src/FftMethod.cpp:1787-1789``).
    """

    prev: torch.Tensor
    first: bool


class FlowResult(NamedTuple):
    """``shifts``: gated per-window shifts ``[..., P, 2]`` (x, y), NaN where
    invalid.  ``shifts_raw``: ungated shifts.  ``response``: correlation
    peak value per window."""

    shifts: torch.Tensor
    shifts_raw: torch.Tensor
    response: torch.Tensor


class FlowEngine(abc.ABC):
    """Engine object; all per-stream state is explicit."""

    @abc.abstractmethod
    def init_state(self) -> FlowState:
        """Fresh state with a black previous frame."""

    @abc.abstractmethod
    def step(self, state: FlowState, frame: torch.Tensor) -> Tuple[FlowState, FlowResult]:
        """One frame in, per-window pixel shifts out."""

    def set_im_prev(self, state: FlowState, frame: torch.Tensor) -> FlowState:
        """``OpticFlowCalc::setImPrev`` (``include/OpticFlowCalc.h:16``):
        a float32 carry, as the JAX base class sets it."""
        return FlowState(prev=frame.to(torch.float32), first=False)

    def step_batch(self, prev_frames: torch.Tensor, curr_frames: torch.Tensor) -> FlowResult:
        """Stateless throughput mode: ``[B, H, W]`` frame pairs in, each
        result stacked along a leading batch dimension.  The default steps
        the pairs one after the other from a state holding the pair's
        previous frame (the JAX base class vmaps the same step); engines
        with a batched kernel (FftMethod) override it."""
        results = [
            self.step(self.set_im_prev(None, p), c)[1] for p, c in zip(prev_frames, curr_frames)
        ]
        return FlowResult(*(torch.stack(parts) for parts in zip(*results)))


class OpticFlowCalc:
    """The reference's stateful interface over a :class:`FlowEngine`
    (``include/OpticFlowCalc.h:9-16``), port of the JAX package's wrapper.

    ``process_image(im_curr, gui, debug, mid_point, yaw_angle, rot_center,
    raw_output, fx, fy) -> [P, 2]`` shifts hides the state threading: the
    path for code written against the reference.  The GUI, debug, midpoint,
    yaw, centre and focal arguments are accepted for the signature and
    ignored, as in the JAX wrapper.  ``raw_output`` is filled in place with
    the ungated shifts where it can take them (a numpy array or a tensor of
    the shape); the reference declares it and never writes it
    (``src/FftMethod.cpp:1772``).  Frames may be numpy arrays or tensors;
    they go to the engine's device.  The wrapper adds no fallback: the
    engine's kernels run as they would without it.
    """

    def __init__(self, engine: FlowEngine):
        self.engine = engine
        self.state = engine.init_state()
        self.last_result: Optional[FlowResult] = None

    def _frame(self, im) -> torch.Tensor:
        if not isinstance(im, torch.Tensor):
            im = torch.from_numpy(np.ascontiguousarray(im))
        return im.to(self.engine.device)

    def process_image(
        self,
        im_curr,
        gui: bool = False,
        debug: bool = False,
        mid_point=None,
        yaw_angle: float = 0.0,
        rot_center=None,
        raw_output=None,
        fx: float = 0.0,
        fy: float = 0.0,
    ) -> torch.Tensor:
        self.state, result = self.engine.step(self.state, self._frame(im_curr))
        self.last_result = result
        if raw_output is not None:
            try:
                if isinstance(raw_output, torch.Tensor):
                    raw_output.copy_(result.shifts_raw)
                else:
                    raw_output[:] = result.shifts_raw.cpu().numpy()
            except (TypeError, ValueError, RuntimeError):
                pass  # an output that cannot take the shifts is left as it is
        return result.shifts

    def process_image_long_range(self, im_curr, *args, **kwargs) -> torch.Tensor:
        """``FftMethod::processImageLongRange`` (``include/FftMethod.h:441``)
        through the same stateful interface; the other arguments are
        ignored."""
        self.state, result = self.engine.step_long_range(self.state, self._frame(im_curr))
        self.last_result = result
        return result.shifts

    def set_im_prev(self, frame):
        """``setImPrev`` (``include/OpticFlowCalc.h:16``): ``frame`` becomes
        the previous frame of the next call."""
        self.state = self.engine.set_im_prev(self.state, self._frame(frame))
