"""Blocks ``jax``, ``yaml`` and ``cv2`` in a process whose ``PYTHONPATH``
holds this directory: an import of any of them raises ``ImportError``, so a
run shows it needs none of them."""
import sys

sys.modules.update(jax=None, yaml=None, cv2=None)
