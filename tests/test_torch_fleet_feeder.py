"""The port's ``FleetFeeder`` on its own native binding
(``mrs_optic_flow_tpu_torch.native``, ``native/libof_runtime.so``): pushes
from a capture thread, ticks that drain every ring to its newest frame,
drop and skip accounting for a full ring, and None when no stream has a
frame.  Runs on the CPU; nothing here is compared with the JAX package."""

import threading

import numpy as np
import pytest
import torch_parity  # noqa: F401  (pins torch to one thread)
from oracle import smooth_random_image

from mrs_optic_flow_tpu_torch import native
from mrs_optic_flow_tpu_torch.parallel import BatchPipeline
from mrs_optic_flow_tpu_torch.runtime import FleetFeeder, FleetServer


@pytest.fixture(autouse=True)
def _native_library():
    """The library is built (``make -C native``) when a test first needs it,
    not while the module is imported."""
    if not native.available():
        pytest.skip("no C++ toolchain")


K = np.array([[40.0, 0, 32.0], [0, 40.0, 32.0], [0, 0, 1.0]], np.float32)
N = 3


def _feeder(capacity=2):
    pipe = BatchPipeline(frame_size=64, sample_point_size=16, camera_matrix=K,
                         dist_coeffs=np.zeros(5, np.float32), ransac_iterations=32, device="cpu")
    return FleetFeeder(FleetServer(pipe, N), frame_shape=(64, 64), capacity=capacity)


def _frame(base, t, i):
    return np.roll(base, (0, t * (1 + i)), (0, 1))


BASE = (smooth_random_image(np.random.default_rng(0), 64, cutoff=0.4) * 127 + 128).astype(np.uint8)


def test_feeder_ticks_drops_and_skips():
    feeder = _feeder()
    assert feeder.tick(np.full(N, 2.0)) is None  # no stream has a frame
    for i in range(N):
        assert feeder.push(i, _frame(BASE, 0, i), 0.0)
    first = feeder.tick(np.full(N, 2.0)).materialize()
    assert not first.ok.any()

    # stream 1 produces nothing this tick: masked out, its state carried
    for i in (0, 2):
        assert feeder.push(i, _frame(BASE, 1, i), 0.1)
    t1 = feeder.tick(np.full(N, 2.0)).materialize()
    assert t1.ok[0] and not t1.ok[1] and t1.ok[2]

    # a full ring (capacity 2): two pushes dropped, the tick takes the
    # newest of the two held frames and skips the other
    pushed = [feeder.push(0, _frame(BASE, 2 + k, 0), 0.2 + 0.05 * k) for k in range(4)]
    assert pushed == [True, True, False, False]
    assert feeder.dropped == 2
    t2 = feeder.tick(np.full(N, 2.0)).materialize()
    assert feeder.frames_skipped == 1
    assert t2.ok[0] and not t2.ok[1:].any()
    assert abs(t2.dts[0] - 0.15) < 1e-9  # newest frame (stamp 0.25) against 0.1
    med = np.nanmedian(t2.shifts[0], axis=0)
    np.testing.assert_allclose(med, [2.0, 0.0], atol=0.3)  # rolled by 3 - 1 ticks of 1 px


def test_feeder_drains_a_capture_thread():
    feeder = _feeder(capacity=8)
    for i in range(N):
        feeder.push(i, _frame(BASE, 0, i), 0.0)
    feeder.tick(np.full(N, 2.0))
    done = threading.Event()

    def capture():
        for i in range(N):
            feeder.push(i, _frame(BASE, 1, i), 0.1)
        done.set()

    th = threading.Thread(target=capture)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive() and done.is_set()
    tick = feeder.tick(np.full(N, 2.0)).materialize()
    assert tick.ok.all() and feeder.dropped == 0
    for i in range(N):
        np.testing.assert_allclose(np.nanmedian(tick.shifts[i], axis=0), [1.0 + i, 0.0], atol=0.3)


def test_frame_queue_and_gather_latest():
    q = native.FrameQueue(4, (2, 3))
    assert q.pop() is None and q.pop_latest() is None and len(q) == 0
    for k in range(3):
        assert q.push(np.full((2, 3), k, np.uint8), float(k))
    assert len(q) == 3
    frame, stamp = q.pop()
    assert stamp == 0.0 and (frame == 0).all()
    frame, stamp, skipped = q.pop_latest()
    assert (stamp, skipped) == (2.0, 1) and (frame == 2).all()
    with pytest.raises(ValueError, match="shape"):
        q.push(np.zeros((3, 3), np.uint8), 0.0)
    with pytest.raises(ValueError, match="frame size"):
        native.gather_latest([q], np.zeros((1, 4, 4), np.uint8), np.zeros(1), np.zeros(1, np.uint8))
    with pytest.raises(ValueError, match="float64"):
        native.gather_latest([q], np.zeros((1, 2, 3), np.uint8), np.zeros(1, np.float32), np.zeros(1, np.uint8))
