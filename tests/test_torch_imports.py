"""The PyTorch port's import rules and the definitions it shares with the
JAX package: no JAX, pyyaml or OpenCV at run time; message types, config
defaults and DFT tables equal to the JAX package's."""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch_parity  # noqa: F401  (pins torch to one thread)

from mrs_optic_flow_tpu.config import load_config
from mrs_optic_flow_tpu.ops import phase_correlate as jax_pc
from mrs_optic_flow_tpu.runtime import msgs as jax_msgs
from mrs_optic_flow_tpu_torch.config import NodeConfig
from mrs_optic_flow_tpu_torch.ops import cuda_kernels
from mrs_optic_flow_tpu_torch.ops import phase_correlate as torch_pc
from mrs_optic_flow_tpu_torch.runtime import msgs as torch_msgs

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "mrs_optic_flow_tpu_torch"


def test_port_imports_without_jax_yaml_cv2():
    code = (
        "import sys; sys.modules.update(jax=None, yaml=None, cv2=None); "
        "import mrs_optic_flow_tpu_torch, mrs_optic_flow_tpu_torch.runtime.node"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


#: an import of jax or of the JAX package (``mrs_optic_flow_tpu``, not the port)
FORBIDDEN_IMPORT = re.compile(
    r"^\s*(from\s+|import\s+([\w.]+(\s+as\s+\w+)?\s*,\s*)*)(jax|mrs_optic_flow_tpu)(?!\w)",
    re.MULTILINE,
)


def test_port_sources_never_import_jax():
    """Neither JAX nor anything of the JAX package, not even a numpy-only
    module, in the port or in ``chip_smoke.py``."""
    for path in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]:
        assert not FORBIDDEN_IMPORT.search(path.read_text()), path


@pytest.mark.parametrize("line,forbidden", [
    ("import jax", True),
    ("import jax.numpy as jnp", True),
    ("from jax import lax", True),
    ("import mrs_optic_flow_tpu", True),
    ("    import mrs_optic_flow_tpu.utils.quat_np as q", True),
    ("from mrs_optic_flow_tpu.utils.quat_np import np_quat_inverse", True),
    ("from mrs_optic_flow_tpu import utils", True),
    ("import numpy, mrs_optic_flow_tpu", True),
    ("import jaxlib", False),
    ("import mrs_optic_flow_tpu_torch", False),
    ("from mrs_optic_flow_tpu_torch.ops import cuda_kernels", False),
    ("from mrs_optic_flow_tpu_torch import models", False),
    ('    "mrs_optic_flow_tpu/ops/pallas_kernels.py:270"', False),
])
def test_forbidden_import_pattern(line, forbidden):
    """The pattern of :func:`test_port_sources_never_import_jax` catches the
    JAX package in every import form and passes the port's own package."""
    assert bool(FORBIDDEN_IMPORT.search(line)) is forbidden


@pytest.mark.parametrize("fn,args", [
    ("np_quat_from_rpy", 3),
    ("np_quat_inverse", (4,)),
    ("np_quat_multiply", ((4,), (4,))),
    ("np_rpy_from_quat", (4,)),
])
def test_quat_np_copy_bit_identical(fn, args):
    """The port's copy of the node's quaternion helpers against the JAX
    package's module on seeded inputs, gimbal-lock quaternions included."""
    from mrs_optic_flow_tpu.utils import quat_np as theirs
    from mrs_optic_flow_tpu_torch.utils import quat_np as ours

    rng = np.random.default_rng(42)
    for trial in range(200):
        if args == 3:
            inputs = tuple(float(v) for v in rng.uniform(-np.pi, np.pi, 3))
        else:
            inputs = tuple(rng.normal(size=shape) for shape in args)
            if fn == "np_rpy_from_quat" and trial < 4:
                # pitch +-90 deg: the getRPY branch at |sin(pitch)| = 1
                s = np.sqrt(0.5)
                inputs = (np.array([[0.0, s, 0.0, s], [0.0, -s, 0.0, s],
                                    [s, 0.0, s, 0.0], [0.0, 0.0, 0.0, 1.0]][trial]),)
        got, want = getattr(ours, fn)(*inputs), getattr(theirs, fn)(*inputs)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize(
    "name",
    ["CameraInfo", "Imu", "Odometry", "Float64Stamped", "ImageMsg", "TrackerStatus",
     "TwistWithCovarianceStamped"],
)
def test_msgs_fields_match_jax(name):
    ours = dataclasses.fields(getattr(torch_msgs, name))
    theirs = dataclasses.fields(getattr(jax_msgs, name))
    assert [(f.name, f.default) for f in ours] == [(f.name, f.default) for f in theirs]


def test_node_config_defaults_match_yaml():
    assert NodeConfig() == NodeConfig.from_optic_flow_config(load_config())


def test_node_config_copies_overrides():
    cfg = load_config(overrides={
        "mrs_optic_flow": {"frame_size": 256, "sample_point_size": 64, "shifted_pts_thr": 10},
        "constraints": {"max_pixel_speed": 40},
        "tpu": {"quantize_8bit": False},
    })
    nc = NodeConfig.from_optic_flow_config(cfg)
    assert (nc.frame_size, nc.sample_point_size, nc.shifted_pts_thr) == (256, 64, 10)
    assert nc.max_pixel_speed == 40 and nc.quantize_8bit is False


@pytest.mark.parametrize("n", [8, 64, 120])
def test_dft_tables_bit_identical(n):
    for ours, theirs in zip(torch_pc._dft_matrices(n), jax_pc._dft_matrices(n)):
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("n", [64, 120])
def test_kernel_twiddles_are_row_one_of_the_dft_matrix(n):
    import torch

    tab = cuda_kernels._twiddles(n, torch.device("cpu")).numpy()
    c, s = jax_pc._dft_matrices(n)
    np.testing.assert_array_equal(tab, np.stack([c[1], s[1]], axis=-1))
    # every matrix entry W[j, k] the kernel reads as tab[j*k mod n]
    idx = np.outer(np.arange(n), np.arange(n)) % n
    assert np.abs(tab[idx, 0] - c).max() < 2e-13 and np.abs(tab[idx, 1] - s).max() < 2e-13
