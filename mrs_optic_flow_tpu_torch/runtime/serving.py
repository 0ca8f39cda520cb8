"""Batched throughput serving over the BatchPipeline (port of
:mod:`mrs_optic_flow_tpu.runtime.serving`).

The deployment shape for fleet workloads: frame pairs accumulate into
fixed-size batches, and batch k+1 is dispatched before batch k's results are
read back, so host I/O and device work overlap (the reference's single
blocking queue cannot, ``src/FftMethod.cpp:398``).  On the card a dispatch
never blocks the host: each batch is staged in pinned host memory (a buffer
per in-flight slot, :class:`~.staging.HostStaging`) and copied with
``non_blocking=True``, the pipeline reads nothing back, and the one host
readback of a batch is in :meth:`ServingLoop._collect`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mrs_optic_flow_tpu_torch.parallel.pipeline import BatchPipeline, PipelineOutput
from mrs_optic_flow_tpu_torch.runtime.staging import HostStaging


@dataclasses.dataclass
class ServingRequest:
    """One frame pair + its scalar context."""

    prev: np.ndarray  # [H, W] or [H, W, 3]
    curr: np.ndarray
    height: float
    dt: float
    rate_quat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    )


@dataclasses.dataclass
class ServingResult:
    ok: bool
    tran: np.ndarray  # [3]
    rot: np.ndarray  # [4]
    shifts: np.ndarray  # [P, 2]
    #: log-polar scale / rotation [rad]: estimates when the pipeline has a
    #: ``scale_rotation`` estimator, NaN otherwise (PipelineOutput)
    scale: float = float("nan")
    rotation: float = float("nan")


#: ``(iterations, p, b) -> [iterations, p, b]`` Gumbel draws of one batch
Draws = Callable[[int, int, int], torch.Tensor]


class ServingLoop:
    def __init__(
        self,
        pipeline: BatchPipeline,
        *,
        batch_size: int = 32,
        depth: int = 2,
        c2b_quat=(0.0, 0.0, 0.0, 1.0),
        seed: int = 0,
        draws: Optional[Draws] = None,
    ):
        """``depth``: dispatched batches in flight before the oldest is read
        back (2 = double buffering).  The RANSAC draws come from a
        ``torch.Generator`` on the pipeline's device seeded with ``seed``,
        or, with ``draws``, from ``draws(iterations, p, batch_size)`` once a
        batch (for instance a replay of another implementation's draws)."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.pipeline = pipeline
        self.device = pipeline.device
        self.batch_size = batch_size
        self.depth = depth
        self.c2b = torch.tensor(c2b_quat, dtype=torch.float32).to(self.device)
        self.draws = draws
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._staging = HostStaging(self.device, slots=depth)

    def _stack(self, name: str, arrays: List[np.ndarray]) -> torch.Tensor:
        """The batch ``[batch_size, ...]`` of ``arrays`` on the device,
        padded by repeating the last one."""
        n = len(arrays)

        def fill(out):
            np.stack(arrays, out=out[:n])
            out[n:] = out[n - 1]

        return self._staging.put(name, (self.batch_size,) + arrays[0].shape, arrays[0].dtype, fill)

    def _dispatch(self, batch: List[ServingRequest]) -> Tuple[PipelineOutput, int]:
        n = len(batch)

        def norm_frame(a):
            # uint8 capture crosses to the card at a quarter of the bytes of
            # float32 (kernel A reads it as it is); anything else becomes
            # float32 on the host.  Decided per array: one wide frame in a
            # batch must not promote (or skip normalizing) the rest
            a = np.asarray(a)
            return a if a.dtype == np.uint8 else np.asarray(a, np.float32)

        def frames(get):
            arrs = [norm_frame(get(r)) for r in batch]
            # a mixed uint8/float batch still needs one dtype: promote to f32
            if any(a.dtype != arrs[0].dtype for a in arrs):
                arrs = [np.asarray(a, np.float32) for a in arrs]
            return arrs

        prev = self._stack("prev", frames(lambda r: r.prev))
        curr = self._stack("curr", frames(lambda r: r.curr))
        scalars = self._stack("scalars", [
            np.concatenate([[r.height, r.dt], np.asarray(r.rate_quat, np.float32)]).astype(np.float32)
            for r in batch])
        gumbel = None
        if self.draws is not None:
            p = self.pipeline.engine.num_windows
            gumbel = torch.as_tensor(self.draws(self.pipeline.ransac_iterations, p, self.batch_size))
            gumbel = gumbel.to(device=self.device, dtype=torch.float32)
        out = self.pipeline.step(prev, curr, scalars[:, 0], scalars[:, 1], scalars[:, 2:6], self.c2b,
                                 gumbel=gumbel, generator=self._gen)
        return out, n

    @staticmethod
    def _collect(out: PipelineOutput, n: int) -> List[ServingResult]:
        """The first ``n`` results of a dispatched batch, read back."""
        ok = out.ok[:n].cpu().numpy()
        tran = out.tran[:n].cpu().numpy()
        rot = out.rot[:n].cpu().numpy()
        shifts = out.shifts[:n].cpu().numpy()
        scale = out.scale[:n].cpu().numpy()
        rotation = out.rotation[:n].cpu().numpy()
        return [
            ServingResult(ok=bool(ok[i]), tran=tran[i], rot=rot[i], shifts=shifts[i],
                          scale=float(scale[i]), rotation=float(rotation[i]))
            for i in range(n)
        ]

    def run(self, requests: Iterable[ServingRequest]) -> Iterator[ServingResult]:
        """Stream requests through the device with up to ``depth`` batches
        in flight (results still come back in order)."""
        in_flight: List[Tuple[PipelineOutput, int]] = []
        batch: List[ServingRequest] = []

        def flush():
            nonlocal batch
            if not batch:
                return []
            in_flight.append(self._dispatch(batch))  # queued on the card
            batch = []
            if len(in_flight) > self.depth - 1:
                return self._collect(*in_flight.pop(0))  # read back the oldest batch
            return []

        for req in requests:
            batch.append(req)
            if len(batch) == self.batch_size:
                yield from flush()
        yield from flush()
        for pending in in_flight:
            yield from self._collect(*pending)
