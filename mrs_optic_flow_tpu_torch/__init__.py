"""mrs_optic_flow_tpu_torch — the PyTorch / CUDA port of mrs_optic_flow_tpu.

The package grows beside the JAX package, which stays the reference it is
tested against.  It imports ``torch`` and never ``jax``.  Layout mirrors the
JAX package: ``ops`` (preprocessing, phase-correlation math, the
hand-written CUDA kernels in ``csrc/``), ``models`` (flow engines),
``geometry`` (getRT), ``filters`` and ``runtime`` (the node).
"""
