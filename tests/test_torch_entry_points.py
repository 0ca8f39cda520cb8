"""The port's entry points run on the card unless the caller asks for the
CPU: built without a device on a host with no CUDA device they raise, and
never fall back to the CPU."""

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)

from mrs_optic_flow_tpu_torch.config import NodeConfig
from mrs_optic_flow_tpu_torch.models import (
    BlockMethod,
    BlockMethodConfig,
    FastSpacedBM,
    FastSpacedBMConfig,
    FftMethod,
    FftMethodConfig,
    ScaleRotationConfig,
    ScaleRotationEstimator,
    make_engine,
)
from mrs_optic_flow_tpu_torch.parallel import BatchPipeline
from mrs_optic_flow_tpu_torch.runtime import FleetServer, ServingLoop
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode
from mrs_optic_flow_tpu_torch.utils.device import resolve_device

SMALL = dict(frame_size=128, sample_point_size=32)
CAMERA = dict(camera_matrix=np.array([[80.0, 0, 64.0], [0, 80.0, 64.0], [0, 0, 1.0]], np.float32),
              dist_coeffs=np.zeros(5, np.float32))


def _pipeline(**kw):
    return BatchPipeline(**SMALL, **CAMERA, **kw)

#: entry point -> a call that builds it at a small size, given extra kwargs
ENTRY_POINTS = {
    "OpticFlowNode": lambda **kw: OpticFlowNode(NodeConfig(**SMALL), log=lambda s: None, **kw),
    "FftMethod": lambda **kw: FftMethod(FftMethodConfig(**SMALL), **kw),
    "BlockMethod": lambda **kw: BlockMethod(BlockMethodConfig(**SMALL, scan_radius=8), **kw),
    "FastSpacedBM": lambda **kw: FastSpacedBM(
        FastSpacedBMConfig(**SMALL, scan_radius=8, step_size=8), **kw),
    "ScaleRotationEstimator": lambda **kw: ScaleRotationEstimator(
        ScaleRotationConfig(resolution=64, magnitude=20.0), **kw),
    "make_engine(3)": lambda **kw: make_engine(3, **SMALL, scan_radius=8, **kw),
    "make_engine(4)": lambda **kw: make_engine(4, **SMALL, **kw),
    "make_engine(5)": lambda **kw: make_engine(5, **SMALL, scan_radius=8, step_size=8, **kw),
    # the serving layer runs on its pipeline's device
    "BatchPipeline": _pipeline,
    "ServingLoop": lambda **kw: ServingLoop(_pipeline(**kw), batch_size=2),
    "FleetServer": lambda **kw: FleetServer(_pipeline(**kw), 2),
}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(name, monkeypatch):
    """Without a device argument: on a host with a CUDA device the entry
    point lands there; on a host without one it raises.  The second case is
    also forced here by hiding the card, so it runs on every host."""
    build = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_runs_on_the_cpu_when_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ENTRY_POINTS[name](device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("device,ok", [("cpu", True), ("cuda", False), ("cuda:0", False)])
def test_resolve_device_without_a_card(device, ok, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if ok:
        assert resolve_device(device) == torch.device(device)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(device)


def test_batch_pipeline_refuses_a_mesh():
    """The JAX package's mesh sharding is not ported: a mesh raises instead
    of being ignored."""
    with pytest.raises(NotImplementedError, match="mesh"):
        _pipeline(mesh=object(), device="cpu")
