"""Host staging filled range by range from several threads, and the fleet's
frames staged crop only (``runtime/staging.py``, ``runtime/serving.py::
ServingLoop._stack``, ``runtime/fleet.py::FleetServer._frames``).

Every comparison here is exact: a fill copies values, and the fleet's grey
crops, shifts, twists and carries from the crop-staged frames must be bit
for bit those of the full-frame route (``BatchPipeline.preprocess`` of the
whole frames, which ``FleetServer`` takes for tensor input), since the grey
conversion is per pixel.
"""

import concurrent.futures
import sys
import threading

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)
from oracle import smooth_random_image

from bench_torch import fleet_cell
from mrs_optic_flow_tpu_torch.models import ScaleRotationConfig, ScaleRotationEstimator
from mrs_optic_flow_tpu_torch.parallel import BatchPipeline
from mrs_optic_flow_tpu_torch.runtime import FleetServer
from mrs_optic_flow_tpu_torch.runtime import staging
from mrs_optic_flow_tpu_torch.runtime.serving import ServingLoop
from mrs_optic_flow_tpu_torch.runtime.staging import HostStaging


class RowsStaging:
    """``HostStaging.put`` with its fill over ``workers`` ranges on a pool
    of its own, into a new array first set to a value no fill writes."""

    def __init__(self, workers: int, batch_size: int = 0):
        self.workers, self.batch_size, self._staging = workers, batch_size, self

    def put(self, name, shape, dtype, fill):
        out = np.full(shape, 77, dtype)
        with concurrent.futures.ThreadPoolExecutor(self.workers) as ex:
            staging.fill_rows(out, fill, self.workers, ex)
        return out


def _source(n, dtype, view):
    a = np.random.default_rng(n).integers(0, 255, (n, 10, 14, 3)).astype(dtype)
    return a[:, 1:9, 3:11] if view == "crop" else a


@pytest.mark.parametrize("view", ["whole", "crop"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("workers", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("n", [1, 3, 128])
def test_chunked_fill_equals_one_copyto(n, workers, dtype, view):
    """``HostStaging.array``'s fill over any number of ranges writes what one
    ``np.copyto`` writes, for strided crop views too."""
    src = _source(n, dtype, view)
    want = np.empty(src.shape, dtype)
    np.copyto(want, src)
    got = HostStaging.array(RowsStaging(workers), "frames", src)
    assert got.dtype == dtype and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def test_cpu_staging_copies_and_uses_the_shared_pool_from_its_size():
    """On a CPU device a fill of ``PARALLEL_MIN_BYTES`` or more runs on the
    shared pool's threads, one range a worker; a smaller one on the calling
    thread.  The result is a copy of the source."""
    names = []

    def fill(out, i, j):
        names.append((threading.current_thread().name, i, j))
        out[i:j] = 1

    rows = 8 * staging.POOL_WORKERS
    big = HostStaging("cpu").put("big", (rows, staging.PARALLEL_MIN_BYTES // rows), np.uint8, fill)
    assert big.numpy().all()
    assert len(names) == staging.POOL_WORKERS and all(nm.startswith("staging") for nm, _, _ in names)
    assert sorted((i, j) for _, i, j in names)[0][0] == 0 and sum(j - i for _, i, j in names) == rows
    names.clear()
    HostStaging("cpu").put("small", (rows, 16), np.uint8, fill)
    assert names == [(threading.current_thread().name, 0, rows)]
    src = np.arange(staging.PARALLEL_MIN_BYTES, dtype=np.uint8).reshape(64, -1)
    out = HostStaging("cpu").array("frames", src)
    src[:] = 0
    assert out.numpy().any()


def test_a_failed_range_raises_after_every_range_is_written():
    done = []

    def fill(out, i, j):
        if i == 0:
            raise RuntimeError("range 0")
        out[i:j] = 1
        done.append(i)

    out = np.zeros((8, 4))
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        with pytest.raises(RuntimeError, match="range 0"):
            staging.fill_rows(out, fill, 4, ex)
    assert sorted(done) == [2, 4, 6] and out[2:].all()


def test_servers_share_the_pool_under_contention():
    """Callers on several threads staging through the shared pool at once
    each get their own array back, with a short switch interval."""
    srcs = [np.random.default_rng(k).integers(0, 255, (32, staging.PARALLEL_MIN_BYTES // 32),
                                              dtype=np.uint8) for k in range(4)]
    bad = []

    def caller(src):
        stage = HostStaging("cpu")
        for _ in range(5):
            if not np.array_equal(stage.array("frames", src).numpy(), src):
                bad.append(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(s,)) for s in srcs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not bad


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("workers", [1, 3, 8])
@pytest.mark.parametrize("n", [1, 5, 8])
def test_stack_pads_by_repeating_the_last_request(n, workers, dtype):
    arrays = [np.full((6, 5), k + 1, dtype) for k in range(n)]
    want = np.stack(arrays + [arrays[-1]] * (8 - n))
    got = ServingLoop._stack(RowsStaging(workers, batch_size=8), "prev", arrays)
    np.testing.assert_array_equal(got, want)


def test_serving_loop_stacks_a_large_batch_on_the_pool():
    k = np.array([[40.0, 0, 32.0], [0, 40.0, 32.0], [0, 0, 1.0]], np.float32)
    pipe = BatchPipeline(frame_size=64, sample_point_size=16, camera_matrix=k,
                         dist_coeffs=np.zeros(5, np.float32), device="cpu")
    loop = ServingLoop(pipe, batch_size=64)
    arrays = [np.random.default_rng(i).random((256, 512), dtype=np.float32) for i in range(50)]
    assert 64 * arrays[0].nbytes >= staging.PARALLEL_MIN_BYTES
    got = loop._stack("prev", arrays).numpy()
    np.testing.assert_array_equal(got, np.stack(arrays + [arrays[-1]] * 14))


# --------------------------------------------------------------------------- #
# the fleet's frames, staged crop only                                         #
# --------------------------------------------------------------------------- #

N, DT = 3, 0.1
K = np.array([[40.0, 0, 50.0], [0, 40.0, 40.0], [0, 0, 1.0]], np.float32)
#: short range: 64 px crops at cx 50 of 112x80 frames; long range: 96 px
#: crops (24 px windows after the 4x downsampling) at cx 60 of 128x104 frames
GEOMETRY = {"short": (dict(frame_size=64, sample_point_size=16, crop_cx=50.0), (80, 112)),
            "long": (dict(frame_size=96, sample_point_size=24, crop_cx=60.0), (104, 128))}
MOVE = [(1, 2), (-2, 1), (3, -1)]  # stream i's (dy, dx) a tick


def _frames(t, hw, bgr, n=N):
    """Stream i's frame at tick t: its texture moved ``t MOVE[i]`` px, each
    BGR channel a texture of its own, so the weights and their order show."""
    texs = [(smooth_random_image(np.random.default_rng(c), 160, cutoff=0.4) * 127 + 128).astype(np.uint8)
            for c in range(3 if bgr else 1)]
    out = []
    for i in range(n):
        dy, dx = MOVE[i % len(MOVE)]
        views = [np.roll(tx, (t * dy + 7 * i, t * dx + 11 * i), (0, 1))[:hw[0], :hw[1]] for tx in texs]
        out.append(np.stack(views, -1) if bgr else views[0])
    return np.stack(out)


def _fleets(geometry, sr):
    """Two servers alike: the first to be fed host arrays, the second
    tensors (the full-frame route)."""
    kw, _ = GEOMETRY[geometry]
    kw = dict(kw, camera_matrix=K, dist_coeffs=np.zeros(5, np.float32), ransac_iterations=32, device="cpu")
    est = (ScaleRotationEstimator(ScaleRotationConfig(resolution=kw["frame_size"], magnitude=15.0), device="cpu")
           if sr else None)
    fleets = []
    for _ in range(2):
        pipe = BatchPipeline(**kw, scale_rotation=est if sr == "fused" else None)
        fleets.append(FleetServer(pipe, N, long_range=geometry == "long", scale_rotation=est, seed=3))
    assert fleets[0]._sr_fused == (sr == "fused")
    return fleets


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert np.array_equal(a, b, equal_nan=True)


CASES = [("short", False, None), ("short", True, None), ("long", False, None), ("long", True, None),
         ("short", True, "fused"), ("short", True, "unfused")]


@pytest.mark.parametrize("geometry,bgr,sr", CASES,
                         ids=["gray", "bgr", "long_gray", "long_bgr", "bgr_sr_fused", "bgr_sr_unfused"])
def test_crop_staging_equals_the_full_frame_route(geometry, bgr, sr):
    """Carried crops and log-polar images, shifts, twists and decodes bit
    for bit, over a dropped frame and a reset; only host arrays are staged."""
    crop_fleet, full_fleet = _fleets(geometry, sr)
    hw = GEOMETRY[geometry][1]
    staged = []
    for label, fleet in (("", crop_fleet), ("full ", full_fleet)):
        fleet._staging.array = lambda name, arr, _l=label, _a=fleet._staging.array: (
            staged.append((_l + name, arr.shape)) or _a(name, arr))
    f = crop_fleet.pipeline.frame_size
    mask = np.ones(N, bool)
    for t in range(4):
        if t == 3:
            for fleet in (crop_fleet, full_fleet):
                fleet.reset(0)
        m = mask.copy()
        m[1] = t != 2
        frames = _frames(t, hw, bgr)
        kw = dict(mask=m, rolls=np.full(N, 0.1), pitches=np.full(N, -0.05)) if geometry == "long" else dict(mask=m)
        a = crop_fleet.tick(frames, np.full(N, t * DT), np.full(N, 2.0), **kw).materialize()
        b = full_fleet.tick(torch.from_numpy(frames), np.full(N, t * DT), np.full(N, 2.0), **kw).materialize()
        for field in ("ok", "tran", "rot", "shifts", "dts", "scale", "rotation"):
            _same(getattr(a, field), getattr(b, field))
        _same(crop_fleet._prev, full_fleet._prev)
        _same(crop_fleet._prev_lp, full_fleet._prev_lp)
    assert a.ok[1:].all() and not a.ok[0]
    assert crop_fleet._prev.shape == (N, f, f) and crop_fleet._prev.dtype == (torch.float32 if bgr else torch.uint8)
    frames_shape = (N, f, f, 3) if bgr else (N, f, f)
    assert [s for s in staged if s[0] == "frames"] == [("frames", frames_shape)] * 4
    assert not [s for s in staged if s[0] == "full frames"]


@pytest.mark.parametrize("cx,hw", [(20.0, (80, 112)), (90.0, (80, 112)), (50.0, (60, 112))],
                         ids=["left", "right", "short_frame"])
def test_a_crop_that_leaves_the_image_raises_before_staging(cx, hw):
    """The same ``ValueError`` as the full-frame route's crop, raised before
    the frames' staging is filled."""
    kw = dict(GEOMETRY["short"][0], crop_cx=cx)
    pipe = BatchPipeline(**kw, camera_matrix=K, dist_coeffs=np.zeros(5, np.float32), device="cpu")
    fleet = FleetServer(pipe, N)
    fleet._staging.put = lambda *a: pytest.fail("staged a crop that leaves the image")
    frames = _frames(0, hw, True)
    with pytest.raises(ValueError, match="leaves the") as crop_err:
        fleet.tick(frames, np.zeros(N), np.ones(N))
    with pytest.raises(ValueError, match="leaves the") as full_err:
        FleetServer(pipe, N).tick(torch.from_numpy(frames), np.zeros(N), np.ones(N))
    assert str(crop_err.value) == str(full_err.value)


def test_fleet_staging_is_timed_once_a_tick_on_the_crops():
    """``fleet_cell.staging_timed`` records one time a tick, the frames'
    one ``HostStaging.array`` call, which now stages the crops."""
    fleet = _fleets("short", None)[0]
    shapes = []
    array = HostStaging.array

    def spy(self, name, arr):
        shapes.append((name, arr.shape))
        return array(self, name, arr)

    fleet._staging.array = spy.__get__(fleet._staging)
    with fleet_cell.staging_timed(fleet) as times:
        for t in range(3):
            fleet.tick(_frames(t, GEOMETRY["short"][1], True), np.full(N, t * DT), np.full(N, 2.0)).materialize()
    assert len(times) == 3 and all(x > 0 for x in times)
    assert [s for s in shapes if s[0] == "frames"] == [("frames", (N, 64, 64, 3))] * 3
