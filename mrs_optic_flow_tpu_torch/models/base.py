"""Abstract flow-engine interface — the ``OpticFlowCalc`` contract
(``include/OpticFlowCalc.h:6-22``), port of :mod:`mrs_optic_flow_tpu.models.base`.

Gray frame in, per-window pixel shifts out, invalid windows poisoned with
NaN; state is explicit: state in, state out.
"""

from __future__ import annotations

import abc
from typing import NamedTuple, Tuple

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
