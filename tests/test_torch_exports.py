"""The port's package exports against the JAX package's: every name of the
JAX top-level ``__getattr__`` and of the JAX ``models``, ``geometry``,
``filters`` and ``parallel`` packages resolves on the port, and importing
the port's top level stays light (no torch, no kernel) with jax, yaml and
cv2 blocked."""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "mrs_optic_flow_tpu"


def _lazy_names():
    """The string constants the JAX top-level ``__getattr__`` tests ``name``
    against."""
    tree = ast.parse((JAX_PKG / "__init__.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "__getattr__")
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare) and isinstance(node.left, ast.Name) and node.left.id == "name":
            for c in ast.walk(node.comparators[0]):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    names.add(c.value)
    return sorted(names)


def _reexports(subpackage):
    """The names the JAX ``subpackage/__init__.py`` imports from its modules."""
    tree = ast.parse((JAX_PKG / subpackage / "__init__.py").read_text())
    return sorted(a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom)
                  for a in n.names)


LAZY = _lazy_names()


def test_the_jax_lists_are_read():
    assert len(LAZY) == 18 and "OpticFlowCalc" in LAZY and "make_mesh" in LAZY


@pytest.mark.parametrize("name", LAZY)
def test_top_level_name_resolves(name):
    import mrs_optic_flow_tpu as jax_pkg
    import mrs_optic_flow_tpu_torch as port

    ours, theirs = getattr(port, name), getattr(jax_pkg, name)
    assert ours.__name__ == theirs.__name__ == name
    assert callable(ours)


def test_unknown_top_level_name_raises():
    import mrs_optic_flow_tpu_torch as port

    with pytest.raises(AttributeError):
        port.no_such_name  # noqa: B018


@pytest.mark.parametrize("subpackage,name", [
    (sub, name) for sub in ("models", "geometry", "filters", "parallel") for name in _reexports(sub)])
def test_subpackage_name_resolves(subpackage, name):
    port = importlib.import_module(f"mrs_optic_flow_tpu_torch.{subpackage}")
    theirs = getattr(importlib.import_module(f"mrs_optic_flow_tpu.{subpackage}"), name)
    ours = getattr(port, name)
    assert type(ours) is type(theirs) or (callable(ours) and callable(theirs)), name


def test_top_level_import_stays_light():
    """``import mrs_optic_flow_tpu_torch`` loads no torch and builds no
    kernel; the first convenience name loads its own module only."""
    code = (
        "import sys; sys.modules.update(jax=None, yaml=None, cv2=None)\n"
        "import mrs_optic_flow_tpu_torch as m\n"
        "assert 'torch' not in sys.modules, 'torch'\n"
        "cfg = m.load_config()\n"
        "assert cfg.frame_size == 480\n"
        "assert 'mrs_optic_flow_tpu_torch.ops.cuda_kernels' not in sys.modules\n"
        "m.OpticFlowCalc, m.make_mesh, m.ServingLoop\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'yaml', 'cv2', 'mrs_optic_flow_tpu') and sys.modules[k] is not None)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
