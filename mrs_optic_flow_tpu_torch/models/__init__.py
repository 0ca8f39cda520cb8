"""Flow engines and the scale/rotation estimator: method 4
(:mod:`.fft_method`), methods 3 and 5 (:mod:`.block_method`,
:mod:`.fast_spaced_bm`) and :mod:`.scale_rotation`."""

from mrs_optic_flow_tpu_torch.models.base import FlowEngine, FlowResult, FlowState  # noqa: F401
from mrs_optic_flow_tpu_torch.models.block_method import BlockMethod, BlockMethodConfig  # noqa: F401
from mrs_optic_flow_tpu_torch.models.fast_spaced_bm import FastSpacedBM, FastSpacedBMConfig  # noqa: F401
from mrs_optic_flow_tpu_torch.models.fft_method import FftMethod, FftMethodConfig  # noqa: F401
from mrs_optic_flow_tpu_torch.models.scale_rotation import (  # noqa: F401
    ScaleRotationConfig,
    ScaleRotationEstimator,
)
from mrs_optic_flow_tpu_torch.utils.device import DEFAULT_DEVICE


def make_engine(method: int, *, device=DEFAULT_DEVICE, **kwargs) -> FlowEngine:
    """Method-id dispatch (``src/optic_flow.cpp:952-1014``): 3 = block
    matching, 4 = FFT, 5 = spaced block matching."""
    if method == 3:
        return BlockMethod(BlockMethodConfig(**kwargs), device=device)
    if method == 4:
        return FftMethod(FftMethodConfig(**kwargs), device=device)
    if method == 5:
        return FastSpacedBM(FastSpacedBMConfig(**kwargs), device=device)
    raise ValueError(f"invalid method id {method} (expected 3, 4, or 5)")
