"""State carried across from the JAX node and fleet.

The system has no learned weights.  What crosses between the two packages
is streaming state, as the JAX package's ``save_state`` writes it to
``.npz``:

- the node's (``runtime/node.py:1048-1075``): the flow carry
  ``prev``/``first``, ``begin``, ``first_image``, ``uav_height``,
  ``angular_rate_quat``, ``c2b_quat``, ``cam_yaw``, ``camera_matrix``,
  ``dist_coeffs``, the readiness flags ``got_height``/``got_tfs``, and the
  scale/rotation carry ``sr_lp``/``sr_first`` (an empty ``sr_lp`` when the
  writer ran no estimator);
- the fleet's (``runtime/fleet.py:156-207``): the preprocessed previous
  frames ``prev`` ``[N, F, F]`` and the log-polar carry ``prev_lp`` (each
  empty when absent), ``prev_stamps``, ``seen`` and ``long_range``.  The
  JAX fleet adds its RANSAC ``key``, a threefry key with no torch
  equivalent; the port's fleet writes its generator state as ``torch_rng``
  instead, which the JAX fleet ignores.
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


@dataclasses.dataclass
class FleetState:
    """The fleet state a checkpoint restores."""

    prev: Optional[torch.Tensor]  # [N, F, F] preprocessed previous frames
    prev_lp: Optional[torch.Tensor]  # [N, L, L] log-polar carry
    prev_stamps: np.ndarray  # [N] float64
    seen: np.ndarray  # [N] bool
    #: the port's generator state (``torch_rng``); None in a JAX checkpoint
    rng_state: Optional[torch.Tensor]


def fleet_state_from_numpy(
    arrays: Mapping[str, np.ndarray],
    device,
    *,
    n_streams: int,
    long_range: bool,
    lp_res: Optional[int],
) -> FleetState:
    """Checkpoint arrays of either package's fleet -> :class:`FleetState`
    with the carries on ``device``, refused with the JAX fleet's
    ``ValueError``s: another range mode, another stream count, a frame batch
    of another size, a log-polar carry for a fleet with no estimator
    (``lp_res`` None) or of another geometry.  A JAX ``key`` is ignored."""
    if bool(arrays["long_range"]) != long_range:
        raise ValueError("checkpoint range mode does not match this server")
    seen = np.asarray(arrays["seen"])
    if seen.shape != (n_streams,):
        raise ValueError(f"checkpoint has {seen.shape[0]} streams, server has {n_streams}")
    prev = None
    if arrays["prev"].size:
        prev = torch.from_numpy(np.array(arrays["prev"])).to(device)
        if prev.shape[0] != n_streams:
            raise ValueError("checkpoint frame batch does not match the stream count")
    prev_lp = None
    if "prev_lp" in arrays and arrays["prev_lp"].size:
        if lp_res is None:
            raise ValueError(
                "checkpoint carries a log-polar state but this server has no scale_rotation estimator")
        if arrays["prev_lp"].shape != (n_streams, lp_res, lp_res):
            raise ValueError(
                f"checkpoint log-polar carry {arrays['prev_lp'].shape} does not match this "
                f"server's ({n_streams}, {lp_res}, {lp_res})")
        prev_lp = torch.from_numpy(np.array(arrays["prev_lp"])).to(device)
    rng = torch.from_numpy(np.array(arrays["torch_rng"])) if "torch_rng" in arrays else None
    return FleetState(prev=prev, prev_lp=prev_lp, prev_stamps=np.asarray(arrays["prev_stamps"]),
                      seen=seen.astype(bool), rng_state=rng)
