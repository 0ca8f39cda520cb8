"""Full float32 precision for the port's float32 contractions, pinned where
they run.

The JAX package passes ``Precision.HIGHEST`` to each float32 contraction
that needs it (``geometry/homography.py``, ``ops/phase_correlate.py``,
``ops/logpolar.py``, ``geometry/motion.py``).  PyTorch's counterpart is a
process-wide setting (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.set_float32_matmul_precision``, which PyTorch keeps in step): a host
process that turns TF32 on would send the port's DFT matrix products and its
3x3 geometry through a 10-bit mantissa.  :func:`full_float32` sets the
setting to ``"highest"`` around a call and gives the caller's setting back.

The pin holds for callers that run the port on one thread, as the node's
callbacks do.  Because the setting is the process's, a host that runs the
port on several threads at once while TF32 is on is not covered: one
thread leaving its block restores TF32 while another is still inside its
own, and inside a block the other threads' matrix products run at full
float32 as well.
"""

from __future__ import annotations

import contextlib
import functools

import torch

#: every function that :func:`pinned` wraps, for the tests
PINNED = []


@contextlib.contextmanager
def full_float32():
    """Float32 matrix products at full precision inside the block; the
    caller's ``float32_matmul_precision`` and ``allow_tf32`` afterwards."""
    precision = torch.get_float32_matmul_precision()
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    if precision == "highest" and not allow_tf32:
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        # PyTorch derives allow_tf32 from this setting: restoring it restores both
        torch.set_float32_matmul_precision(precision)


def pinned(fn):
    """``fn`` run inside :func:`full_float32`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with full_float32():
            return fn(*args, **kwargs)

    PINNED.append(wrapper)
    return wrapper
