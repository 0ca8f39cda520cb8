#!/usr/bin/env python3
"""Time the host's fill of a fleet tick's and a serving batch's pinned slot,
by the number of threads that fill it.

    python3 scripts/profile_staging_torch.py [--workers 1,2,4,8,16] [--reps 7]
        [--streams 128] [--batch 512] [--device cuda|cpu]

Each fill runs the staging's own code (``runtime/staging.py::fill_rows``,
one contiguous range of axis 0 a worker, on a pool of that many threads)
into one pinned buffer a name, allocated before the clock, and each line
gives the median (and every run) of ``--reps`` fills after a warm one:

- ``fleet_tick``: ``--streams`` 752x480 bgr8 frames as one array, by
  ``layout``: ``full`` (the whole frames, 138.6 MB at 128 streams), ``crop``
  (``HostStaging.array`` of the 480-square crop at cx 376, the strided
  view ``FleetServer`` stages: 88.5 MB) and ``crop_rows`` (the same crop
  copied as rows of 1,440 bytes, a ``np.void`` view of each side);
- ``serving_batch``: ``ServingLoop._stack`` of ``--batch`` 480x480 uint8
  requests, ``prev`` then ``curr`` (236 MB at 512), each request a view of
  one array of the batch's frames, as the serving cell holds them;
- ``small``: ``HostStaging.array`` of a contiguous uint8 array of 64 KiB to
  64 MiB at 1 worker and at the shared pool's size, for the size under
  which a fill stays on the calling thread (``PARALLEL_MIN_BYTES``);
- ``fleet_tick_on_card`` (the card only): the crop from the fill's start
  until it is on the card (``torch.cuda.synchronize``), by ``upload``:
  ``after_fill`` (``HostStaging.array``: the shared pool's fill, then one
  copy) or ``by_range`` (the same fill in four ranges a worker, each range
  copied to the card by the calling thread as soon as it is written, in
  order: the overlap the staging does not use);
- ``grey_crop`` (the card only), at ``--streams``, 16, 4 and 1 streams: the
  grey of the whole frames then cropped (``BatchPipeline.preprocess``)
  against the grey of the uploaded crop (``preprocess_crops``): whether
  they are equal bit for bit, their largest difference, each one's ms by
  CUDA events, each one's peak device memory, and each upload's ms.

Every line has ``gbps`` (bytes written over the median), ``cpus``
(``len(os.sched_getaffinity(0))``) and the card's ``nvidia-smi`` name and
power limit.  With ``--device cpu`` the buffers are ordinary memory and
``card`` is ``cpu``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FRAME = (480, 752, 3)  # the fleet's bgr8 frames
CROP, CX = 480, 376
SMALL = (1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24, 1 << 25, 1 << 26)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", default="1,2,4,8,16")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--streams", type=int, default=128)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class TimedSlots:
    """``HostStaging.put`` into one buffer a name (pinned on the card),
    its fill timed: ``fill_rows`` over ``workers`` ranges on ``executor``."""

    def __init__(self, pinned: bool, workers: int, executor):
        self.pinned, self.workers, self.executor = pinned, workers, executor
        self.bufs: dict = {}
        self.ms = 0.0

    def buffer(self, name, shape, dtype) -> np.ndarray:
        import torch

        if name not in self.bufs:
            if self.pinned:
                t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype, pin_memory=True)
                self.bufs[name] = t.numpy()
            else:
                self.bufs[name] = np.empty(shape, dtype)
        return self.bufs[name]

    def fill(self, out, fill):
        from mrs_optic_flow_tpu_torch.runtime import staging

        t0 = time.perf_counter()
        staging.fill_rows(out, fill, self.workers, self.executor)
        self.ms += (time.perf_counter() - t0) * 1e3

    def put(self, name, shape, dtype, fill):
        out = self.buffer(name, tuple(shape), np.dtype(dtype))
        self.fill(out, fill)
        return out


def median_fill(slots: TimedSlots, once, reps: int) -> list:
    """``once()`` (its staging's fills) ``reps`` times after a warm one:
    each run's ms."""
    once()
    runs = []
    for _ in range(reps):
        slots.ms = 0.0
        once()
        runs.append(slots.ms)
    return runs


def cases(args):
    """(metric, fields, bytes written, ``once(slots)``) of every case."""
    from mrs_optic_flow_tpu_torch.runtime.serving import ServingLoop
    from mrs_optic_flow_tpu_torch.runtime.staging import HostStaging

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (args.streams,) + FRAME, dtype=np.uint8)
    xi, yi = CX - CROP // 2, FRAME[0] // 2 - CROP // 2
    crop = frames[:, yi:yi + CROP, xi:xi + CROP]
    row = np.dtype((np.void, CROP * 3))
    crop_rows = crop.reshape(args.streams, CROP, CROP * 3).view(row)

    def rows_copy(s):
        out = s.buffer("rows", crop.shape, np.uint8).reshape(args.streams, CROP, CROP * 3).view(row)
        s.fill(out, lambda o, i, j: np.copyto(o[i:j], crop_rows[i:j]))

    yield "fleet_tick", {"layout": "full"}, frames.nbytes, lambda s: HostStaging.array(s, "frames", frames)
    yield "fleet_tick", {"layout": "crop"}, crop.nbytes, lambda s: HostStaging.array(s, "frames", crop)
    yield "fleet_tick", {"layout": "crop_rows"}, crop.nbytes, rows_copy
    pairs = rng.integers(0, 256, (2, args.batch, CROP, CROP), dtype=np.uint8)
    reqs = [list(pairs[0]), list(pairs[1])]

    def serve(s):
        loop = type("Stand", (), {"batch_size": args.batch, "_staging": s})()
        ServingLoop._stack(loop, "prev", reqs[0])
        ServingLoop._stack(loop, "curr", reqs[1])

    yield "serving_batch", {"requests": args.batch}, pairs.nbytes, serve
    for size in SMALL:
        arr = rng.integers(0, 256, size, dtype=np.uint8).reshape(-1, 1024)
        yield "small", {"bytes": size}, size, lambda s, a=arr: HostStaging.array(s, f"small{a.size}", a)


def run(args, emit) -> bool:
    import torch

    from mrs_optic_flow_tpu_torch.runtime import staging
    from mrs_optic_flow_tpu_torch.utils import benchlib

    cuda = args.device != "cpu"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = benchlib.card_name() if cuda else "cpu"
    workers = [int(w) for w in args.workers.split(",")]
    base = {"cpus": len(os.sched_getaffinity(0)), "pool_workers": staging.POOL_WORKERS, "card": card}
    for metric, fields, nbytes, once in cases(args):
        counts = [1, staging.POOL_WORKERS] if metric == "small" else workers
        for w in counts:
            with concurrent.futures.ThreadPoolExecutor(w) as ex:
                slots = TimedSlots(cuda, w, ex)
                runs = median_fill(slots, lambda: once(slots), args.reps)
            ms = float(np.median(runs))
            emit({"metric": metric, **fields, "workers": w, "bytes": nbytes, "ms": ms,
                  "runs_ms": [round(r, 4) for r in runs], "gbps": nbytes / ms / 1e6, **base})
    if cuda:
        on_card(args, emit, base)
        grey(args, emit, base)
    return True


def grey(args, emit, base):
    """``grey_crop``: the two routes to a fleet tick's grey crops."""
    import torch

    from mrs_optic_flow_tpu_torch.ops.preprocess import center_crop, to_grayscale
    from mrs_optic_flow_tpu_torch.utils import benchlib

    dev = torch.device("cuda")
    xi, yi = CX - CROP // 2, FRAME[0] // 2 - CROP // 2
    rng = np.random.default_rng(2)
    for n in sorted({args.streams, 16, 4, 1}, reverse=True):
        frames = rng.integers(0, 256, (n,) + FRAME, dtype=np.uint8)
        host = {"full": torch.from_numpy(frames).pin_memory(),
                "crop": torch.from_numpy(np.ascontiguousarray(frames[:, yi:yi + CROP, xi:xi + CROP])).pin_memory()}
        dev_in = {k: v.to(dev) for k, v in host.items()}
        ways = {"full": lambda: center_crop(to_grayscale(dev_in["full"]), CROP, CX).contiguous(),
                "crop": lambda: to_grayscale(dev_in["crop"]).contiguous()}
        row = {"metric": "grey_crop", "streams": n}
        got = {}
        for name, fn in ways.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            got[name] = fn()
            torch.cuda.synchronize()
            row[f"{name}_peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
            row[f"{name}_ms"] = benchlib.time_cuda(fn, 20)
            row[f"{name}_upload_ms"] = benchlib.time_cuda(
                lambda t=host[name]: t.to(dev, non_blocking=True), 5)
        row["bit_equal"] = bool(torch.equal(got["full"], got["crop"]))
        row["max_abs_diff"] = float((got["full"] - got["crop"]).abs().max())
        emit({**row, **base})


def on_card(args, emit, base):
    """``fleet_tick_on_card``: the crop staged and then uploaded against the
    same crop uploaded range by range as the ranges are written."""
    import torch

    from mrs_optic_flow_tpu_torch.runtime import staging
    from mrs_optic_flow_tpu_torch.runtime.staging import HostStaging

    dev = torch.device("cuda")
    frames = np.random.default_rng(1).integers(0, 256, (args.streams,) + FRAME, dtype=np.uint8)
    xi, yi = CX - CROP // 2, FRAME[0] // 2 - CROP // 2
    crop = frames[:, yi:yi + CROP, xi:xi + CROP]
    stage = HostStaging(dev, slots=1)
    pinned = torch.empty(crop.shape, dtype=torch.uint8, pin_memory=True)
    parts = 4 * staging.POOL_WORKERS
    edges = [len(crop) * k // parts for k in range(parts + 1)]

    def by_range():
        out = torch.empty(crop.shape, dtype=torch.uint8, device=dev)
        futures = [staging.shared_pool().submit(np.copyto, pinned.numpy()[i:j], crop[i:j])
                   for i, j in zip(edges, edges[1:])]
        for i, j, f in zip(edges, edges[1:], futures):
            f.result()
            out[i:j].copy_(pinned[i:j], non_blocking=True)
        return out

    ways = {"by_range": by_range, "after_fill": lambda: stage.array("frames", crop)}
    runs = {k: [] for k in ways}
    for rep in range(args.reps + 1):
        for name in (ways if rep % 2 else reversed(list(ways))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = ways[name]()
            torch.cuda.synchronize()
            if rep:
                runs[name].append((time.perf_counter() - t0) * 1e3)
            if not torch.equal(got.cpu(), torch.from_numpy(np.ascontiguousarray(crop))):
                raise RuntimeError(f"{name}: the card's crop differs from the host's")
    for name, r in runs.items():
        ms = float(np.median(r))
        emit({"metric": "fleet_tick_on_card", "upload": name, "workers": staging.POOL_WORKERS,
              "bytes": crop.nbytes, "ms": ms, "runs_ms": [round(x, 4) for x in r],
              "gbps": crop.nbytes / ms / 1e6, **base})


def main(argv=None) -> int:
    args = parse_args(argv)

    def emit(row):
        print(json.dumps(row), flush=True)

    return 0 if run(args, emit) else 1


if __name__ == "__main__":
    sys.exit(main())
