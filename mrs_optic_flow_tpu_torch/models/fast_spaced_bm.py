"""FastSpacedBMMethod — spaced-grid SAD and histogram vote (method 5,
dormant in the reference).

Port of :mod:`mrs_optic_flow_tpu.models.fast_spaced_bm`, the rebuild of the
OpenCL pair ``OptFlow_C1_D0`` + ``Histogram_C1_D0``
(``src/FastSpacedBMMethod.cl:4-169``) and its host driver
(``src/FastSpacedBMMethod_OCL.cpp:74-184``): SAD search on a grid spaced by
``sample_point_size + step_size``, flat-area rejection, then a histogram
vote whose top-``TestDepth`` x/y values form candidate vectors; the output
is the single most-voted vector (``:178-180``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mrs_optic_flow_tpu_torch.models.base import FlowResult
from mrs_optic_flow_tpu_torch.models.block_method import SadEngine
from mrs_optic_flow_tpu_torch.ops.block_matching import histogram_vote, sad_min_flow
from mrs_optic_flow_tpu_torch.utils.device import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class FastSpacedBMConfig:
    frame_size: int = 480
    sample_point_size: int = 120  # blockSize
    scan_radius: int = 21
    step_size: int = 24  # blockStep (grid pitch = size + step)
    test_depth: int = 3  # TestDepth (src/FastSpacedBMMethod_OCL.cpp:100)
    use_pallas: bool = True  # kernel C, else the plain SAD search


class FastSpacedBM(SadEngine):
    def __init__(self, config: FastSpacedBMConfig = FastSpacedBMConfig(), *, device=DEFAULT_DEVICE):
        c = config
        pitch = c.sample_point_size + c.step_size
        #: grid = (cols - 2R) / pitch (src/FastSpacedBMMethod_OCL.cpp:88)
        self.grid_side = (c.frame_size - 2 * c.scan_radius) // pitch
        i = np.arange(self.grid_side)
        # block origin: blockX * pitch + scanRadius (src/FastSpacedBMMethod.cl:28-31)
        xs, ys = np.meshgrid(i * pitch + c.scan_radius, i * pitch + c.scan_radius)
        origins = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int64)
        super().__init__(config, origins, device=device)

    def _match(self, curr: torch.Tensor, prev: torch.Tensor) -> FlowResult:
        c = self.config
        # flat-area -> (0, 0): MinValThreshold = scanRadius^2 * 0.2
        # (src/FastSpacedBMMethod.cl:2, :79-84)
        cell_flow = sad_min_flow(
            self._sad(curr, prev), c.scan_radius, noise_threshold=c.scan_radius**2 * 0.2
        )
        top_x, top_y = histogram_vote(cell_flow, c.scan_radius, top_k=c.test_depth)
        # the candidates are the TestDepth x TestDepth (x, y) combinations
        # (src/FastSpacedBMMethod.cl:154-163); only combo (0, 0), the two
        # most-voted values, is published.  Sign normalized to content
        # motion as in BlockMethod.
        return FlowResult(
            shifts=-torch.stack([top_x[0], top_y[0]])[None, :].to(torch.float32),
            shifts_raw=-cell_flow.to(torch.float32),
            response=torch.zeros((1,), dtype=torch.float32, device=curr.device),
        )
