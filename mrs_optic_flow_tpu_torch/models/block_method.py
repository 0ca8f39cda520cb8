"""BlockMethod — SAD block matching (method 3, dormant in the reference).

Port of :mod:`mrs_optic_flow_tpu.models.block_method`, the rebuild of
``BlockMethod`` (``src/BlockMethod.cpp:4-147``): exhaustive SAD search on a
grid, independent x/y histogram vote over the per-cell winners, iterative
2x-upsample sub-pixel refinement, one aggregated flow vector out.  The SAD
maps come from kernel C
(:func:`~mrs_optic_flow_tpu_torch.ops.cuda_kernels.sad_search`) with
``use_pallas``, else from its plain twin.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Tuple

import numpy as np
import torch

from mrs_optic_flow_tpu_torch.models.base import FlowEngine, FlowResult, FlowState
from mrs_optic_flow_tpu_torch.ops import block_matching, cuda_kernels
from mrs_optic_flow_tpu_torch.ops.block_matching import (
    extract_blocks,
    histogram_vote,
    refine_subpixel,
    sad_min_flow,
)
from mrs_optic_flow_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class BlockMethodConfig:
    """Ctor args of ``BlockMethod`` (``src/BlockMethod.cpp:4-10``)."""

    frame_size: int = 480
    sample_point_size: int = 120
    scan_radius: int = 21
    step_size: int = 24  # unused by BlockMethod's own grid, kept for parity
    refine_passes: int = 2  # Refine(..., 2), src/BlockMethod.cpp:82
    use_pallas: bool = True  # kernel C, else the plain SAD search


class SadEngine(FlowEngine):
    """What the two SAD engines share: a grid of ``[S, S]`` blocks at
    static origins, each searched over ``+-scan_radius`` in the previous
    frame, and a float32 carry of the previous frame."""

    def __init__(self, config, origins: np.ndarray, *, device=DEFAULT_DEVICE):
        self.config = config
        self.device = resolve_device(device)
        self._origins = origins
        self.num_cells = len(origins)

    def init_state(self) -> FlowState:
        c = self.config
        return FlowState(
            prev=torch.zeros((c.frame_size, c.frame_size), dtype=torch.float32, device=self.device),
            first=True,
        )

    def _sad(self, curr: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
        """``[G, D, D]`` SAD maps of the grid cells."""
        c = self.config
        curr_blocks = extract_blocks(curr, self._origins, c.sample_point_size)
        prev_regions = extract_blocks(
            prev, self._origins - c.scan_radius, c.sample_point_size + 2 * c.scan_radius
        )
        search = cuda_kernels.sad_search if c.use_pallas else block_matching.sad_search
        return search(
            curr_blocks.contiguous(), prev_regions.contiguous(),
            block_size=c.sample_point_size, scan_radius=c.scan_radius,
        )

    @abc.abstractmethod
    def _match(self, curr: torch.Tensor, prev: torch.Tensor) -> FlowResult:
        """The engine's flow between two float32 frames."""

    def step(self, state: FlowState, frame: torch.Tensor) -> Tuple[FlowState, FlowResult]:
        curr = frame.to(torch.float32)
        prev = curr if state.first else state.prev
        return FlowState(prev=curr, first=False), self._match(curr, prev)


class BlockMethod(SadEngine):
    def __init__(self, config: BlockMethodConfig = BlockMethodConfig(), *, device=DEFAULT_DEVICE):
        c = config
        #: maxSamplesSide = (frameSize - 2R) / samplePointSize (src/BlockMethod.cpp:12)
        self.grid_side = (c.frame_size - 2 * c.scan_radius) // c.sample_point_size
        # startPos = (n*S + R, m*S + R) (src/BlockMethod.cpp:45)
        i = np.arange(self.grid_side)
        xs, ys = np.meshgrid(i * c.sample_point_size + c.scan_radius,
                             i * c.sample_point_size + c.scan_radius)
        origins = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int64)
        super().__init__(config, origins, device=device)

    def _match(self, curr: torch.Tensor, prev: torch.Tensor) -> FlowResult:
        """``BlockMethod::processImage`` (``src/BlockMethod.cpp:25-94``):
        per-cell SAD argmin -> x/y histogram vote -> sub-pixel refine -> one
        flow vector.  SAD matching finds the offset of the matching block in
        the previous frame, the negated content motion; the sign is
        normalized to the engines' convention ``curr(x) ~= prev(x - d)``."""
        c = self.config
        cell_flow = sad_min_flow(self._sad(curr, prev), c.scan_radius)
        top_x, top_y = histogram_vote(cell_flow, c.scan_radius)
        refined = refine_subpixel(
            curr, prev, torch.cat([top_x[:1], top_y[:1]]), passes=c.refine_passes
        )
        return FlowResult(
            shifts=-refined[None, :],
            shifts_raw=-cell_flow.to(torch.float32),
            response=torch.zeros((1,), dtype=torch.float32, device=curr.device),
        )
