"""mrs_optic_flow_tpu_torch — the PyTorch / CUDA port of mrs_optic_flow_tpu.

The package grows beside the JAX package, which stays the reference it is
tested against.  It imports ``torch`` and never ``jax``.  Layout mirrors the
JAX package: ``ops`` (preprocessing, phase-correlation math, the
hand-written CUDA kernels in ``csrc/``), ``models`` (flow engines and
``OpticFlowCalc``), ``geometry`` (getRT), ``filters``, ``parallel`` (the
batched pipeline and its mesh) and ``runtime`` (the node, serving, flights,
bridges and bags).

The top-level names of the JAX package resolve here too, on first use:
importing the package imports none of its modules, so ``--help`` and
config-only callers load nothing of torch's device stack and build no
kernel.
"""

__version__ = "0.1.0"

#: top-level name -> the module that defines it, as in the JAX package's ``__getattr__``
_LAZY = {
    **dict.fromkeys(("phase_correlate_field", "correlation_surface", "peak_refine"),
                    "mrs_optic_flow_tpu_torch.ops.phase_correlate"),
    **dict.fromkeys(("FftMethod", "FftMethodConfig", "BlockMethod", "FastSpacedBM",
                     "ScaleRotationEstimator", "OpticFlowCalc", "make_engine"),
                    "mrs_optic_flow_tpu_torch.models"),
    **dict.fromkeys(("OpticFlowNode", "FrameStream", "SyntheticScene", "FleetServer"),
                    "mrs_optic_flow_tpu_torch.runtime"),
    **dict.fromkeys(("BatchPipeline", "make_mesh"), "mrs_optic_flow_tpu_torch.parallel"),
    "ServingLoop": "mrs_optic_flow_tpu_torch.runtime.serving",
    "load_config": "mrs_optic_flow_tpu_torch.config",
}


def __getattr__(name):
    """The JAX package's lazy top-level conveniences."""
    if name not in _LAZY:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(_LAZY[name]), name)
