"""Batched serving on one card: :class:`BatchPipeline` (port of
:mod:`mrs_optic_flow_tpu.parallel`; the JAX package's mesh sharding is not
ported, the port runs on one H100)."""

from mrs_optic_flow_tpu_torch.parallel.pipeline import (  # noqa: F401
    BatchPipeline,
    LongRangeOutput,
    PipelineOutput,
)
