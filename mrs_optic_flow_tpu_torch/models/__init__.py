"""Flow engines.  The port has method 4 (:mod:`.fft_method`); block matching
(methods 3 and 5) and scale/rotation wait for kernels C and B (ROADMAP)."""

from mrs_optic_flow_tpu_torch.models.base import FlowEngine, FlowResult, FlowState  # noqa: F401
from mrs_optic_flow_tpu_torch.models.fft_method import FftMethod, FftMethodConfig  # noqa: F401


def make_engine(method: int, *, device="cpu", **kwargs) -> FlowEngine:
    """Method-id dispatch (``src/optic_flow.cpp:952-1014``): 4 = FFT."""
    if method == 4:
        return FftMethod(FftMethodConfig(**kwargs), device=device)
    if method in (3, 5):
        raise NotImplementedError(
            f"method {method} (block matching) is not ported yet (ROADMAP queue 1 item 10)"
        )
    raise ValueError(f"invalid method id {method} (expected 3, 4, or 5)")
