"""Batched serving and its sharding (port of :mod:`mrs_optic_flow_tpu.parallel`):
:class:`BatchPipeline`, and :func:`make_mesh`, :func:`shard_batch` and
:func:`sharded_flow_step`, which split a batch of frame pairs over several
cards or several shards of one card."""

from mrs_optic_flow_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    Sharded,
    make_mesh,
    shard_batch,
    sharded_flow_step,
)
from mrs_optic_flow_tpu_torch.parallel.pipeline import (  # noqa: F401
    BatchPipeline,
    LongRangeOutput,
    PipelineOutput,
)
