"""State carried across from the JAX node.

The system has no learned weights.  What crosses between the two packages
is the node's streaming state and calibration, as the JAX node's
``save_state`` writes them to ``.npz`` (``runtime/node.py:1048-1075``): the
flow carry ``prev``/``first``, ``begin``, ``first_image``, ``uav_height``,
``angular_rate_quat``, ``c2b_quat``, ``cam_yaw``, ``camera_matrix``,
``dist_coeffs``, the readiness flags ``got_height``/``got_tfs``, and the
scale/rotation carry ``sr_lp``/``sr_first`` (an empty ``sr_lp`` when the
writer ran no estimator).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from mrs_optic_flow_tpu_torch.models.base import FlowState
from mrs_optic_flow_tpu_torch.ops.preprocess import quantize_u8


@dataclasses.dataclass
class NodeState:
    """The node state a checkpoint restores; ``None`` fields are absent
    from the checkpoint and leave the node's value as it is."""

    flow_state: FlowState
    begin: Optional[float]
    first_image: bool
    uav_height: float
    angular_rate_quat: np.ndarray
    c2b_quat: np.ndarray
    cam_yaw: float
    camera_matrix: Optional[np.ndarray]
    dist_coeffs: Optional[np.ndarray]
    got_height: Optional[bool]
    got_tfs: Optional[bool]
    #: scale/rotation carry; None when the checkpoint has none or the
    #: reading node runs no estimator
    sr_lp: Optional[torch.Tensor] = None
    sr_first: Optional[bool] = None


def _adapt_carry(carry: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A carry of the other dtype converted, through the 8-bit rounding when
    the node carries uint8."""
    if carry.dtype == dtype:
        return carry
    return quantize_u8(carry) if dtype == torch.uint8 else carry.to(dtype)


def node_state_from_numpy(
    arrays: Mapping[str, np.ndarray],
    device,
    *,
    carry_shape: tuple,
    carry_dtype: torch.dtype,
    sr_shape: Optional[tuple] = None,
    sr_dtype: Optional[torch.dtype] = None,
) -> NodeState:
    """Checkpoint arrays -> :class:`NodeState` with the carries on
    ``device``.

    The flow carry must have the node's frame geometry ``carry_shape`` (a
    mismatch raises ``ValueError``, as the JAX node does); a carry of the
    other dtype is converted, through the 8-bit rounding when the node
    carries uint8.  Checkpoints without the readiness flags infer them from
    the presence of a camera matrix, as the JAX node does.  ``sr_shape`` and
    ``sr_dtype`` describe the node's scale/rotation carry (None when it runs
    no estimator); a non-empty ``sr_lp`` gets the same geometry check and
    dtype adaptation.
    """
    prev = torch.from_numpy(np.array(arrays["prev"])).to(device)
    if tuple(prev.shape) != tuple(carry_shape):
        raise ValueError(
            f"checkpoint flow carry {tuple(prev.shape)} does not match this "
            f"node's frame geometry {tuple(carry_shape)}"
        )
    prev = _adapt_carry(prev, carry_dtype)
    sr_lp = sr_first = None
    if sr_shape is not None and "sr_lp" in arrays and arrays["sr_lp"].size:
        if tuple(arrays["sr_lp"].shape) != tuple(sr_shape):
            raise ValueError(
                f"checkpoint log-polar carry {tuple(arrays['sr_lp'].shape)} does not "
                f"match this node's {tuple(sr_shape)}"
            )
        sr_lp = _adapt_carry(torch.from_numpy(np.array(arrays["sr_lp"])).to(device), sr_dtype)
        sr_first = bool(arrays["sr_first"])
    begin = float(arrays["begin"])
    has_camera = arrays["camera_matrix"].size > 0
    if "got_height" in arrays:
        got_height, got_tfs = bool(arrays["got_height"]), bool(arrays["got_tfs"])
    elif has_camera:
        got_height = got_tfs = True
    else:
        got_height = got_tfs = None
    return NodeState(
        flow_state=FlowState(prev=prev, first=bool(arrays["first"])),
        begin=None if np.isnan(begin) else begin,
        first_image=bool(arrays["first_image"]),
        uav_height=float(arrays["uav_height"]),
        angular_rate_quat=np.asarray(arrays["angular_rate_quat"], np.float64),
        c2b_quat=np.asarray(arrays["c2b_quat"], np.float64),
        cam_yaw=float(arrays["cam_yaw"]),
        camera_matrix=np.asarray(arrays["camera_matrix"]) if has_camera else None,
        dist_coeffs=np.asarray(arrays["dist_coeffs"]) if has_camera else None,
        got_height=got_height,
        got_tfs=got_tfs,
        sr_lp=sr_lp,
        sr_first=sr_first,
    )
