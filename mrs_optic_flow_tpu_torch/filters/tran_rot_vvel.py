"""Translation, yaw rate and climb rate from a 3x3 flow grid
(``estimateTranRotVvel``, ``src/utilityFunctions.cpp:347-495``).

Port of :mod:`mrs_optic_flow_tpu.filters.tran_rot_vvel`.  The input is the
grid's flow in column-major order, ``vectors = [r1 r4 r7 r2 r5 r8 r3 r6
r9]`` for the row-major cells r1..r9 (``:360-369``), at grid arm length
``a`` pixels:

- the translation is the allsac fusion of the four opposite-pair means and
  the centre vector (``:371-399``);
- the yaw rate comes from the rotational component of the eight outer
  vectors once the translation is removed (``:417-447``, averaged
  ``:461-466``);
- the vertical velocity comes from their radial (scale) component
  (``:469-478``).

The reference's unit handling is kept: y is flipped on input (``:358``), the
translation allsac runs in m/s (``:388``) and comes back to pixels with y
negated (``:395-396``), no valid estimate gives NaN, and the absolute bounds
map to NaN (``:483-489``).  The scalars are taken in the vectors' dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mrs_optic_flow_tpu_torch.filters.allsac import allsac_mean


class TranRotVvel(NamedTuple):
    tran: torch.Tensor  # [2] translation [px, the reference's convention]
    rot: torch.Tensor  # [] yaw rate [rad/s], NaN if out of bounds or unknown
    vvel: torch.Tensor  # [] vertical velocity [m/s], NaN if out of bounds or unknown


def _sum_count(est: torch.Tensor):
    """The sum of the finite entries of ``est``, their count (at least 1),
    and whether there is any."""
    ok = torch.isfinite(est)
    return torch.where(ok, est, 0.0).sum(), torch.clamp(ok.sum(), min=1), ok.any()


def estimate_tran_rot_vvel(
    vectors: torch.Tensor,
    a,
    fx,
    fy,
    range_,
    allsac_radius_sq,
    duration,
    max_vert_speed,
    max_yaw_speed,
) -> TranRotVvel:
    """``vectors`` ``[9, 2]``: the column-major 3x3 grid's flow, NaN
    tolerated.  The other arguments are numbers or 0-d tensors."""

    def scalar(x):
        return torch.as_tensor(x, dtype=vectors.dtype)

    a, fx, fy, range_, duration = (scalar(x) for x in (a, fx, fy, range_, duration))
    v = torch.stack([vectors[:, 0], -vectors[:, 1]], dim=-1)  # flip y (:358)
    r1, r4, r7, r2, r5, r8, r3, r6, r9 = v.unbind(0)  # row-major r1..r9 (:360-369)

    # translation hypotheses: opposite pairs and the centre (:373-379)
    t_est = torch.stack([0.5 * (r1 + r9), 0.5 * (r3 + r7), 0.5 * (r2 + r8), 0.5 * (r4 + r6), r5])
    t_valid = torch.isfinite(t_est).all(dim=-1)
    t_est = torch.where(t_valid[:, None], t_est, 0.0)
    # to m/s (:388), allsac (:392), back to px with y negated (:395-396)
    t_ms = torch.stack([t_est[:, 0] * (range_ / (fx * duration)),
                        t_est[:, 1] * (range_ / (fy * duration))], dim=-1)
    tr_ms, _ = allsac_mean(t_ms, t_valid, scalar(allsac_radius_sq))
    tr = torch.stack([tr_ms[0] * (fx * duration / range_), tr_ms[1] * (-(fy * duration) / range_)])

    # the translation removed from the outer vectors (:411-419)
    r1, r2, r3, r4 = r1 - tr, r2 - tr, r3 - tr, r4 - tr
    r6, r7, r8, r9 = r6 - tr, r7 - tr, r8 - tr, r9 - tr

    # rotation and scale components (:421-447)
    r_est = torch.stack([
        (r1[1] + r1[0]) / 2, (-r9[0] - r9[1]) / 2, (r3[0] - r3[1]) / 2, (r7[1] - r7[0]) / 2,
        r4[1], -r6[1], r2[0], -r8[0],
    ])
    s_est = torch.stack([
        (r1[1] - r1[0]) / 2, (-r9[1] + r9[0]) / 2, (r3[1] + r3[0]) / 2, (-r7[1] - r7[0]) / 2,
        -r4[0], r6[0], r2[1], -r8[1],
    ])
    # yaw rate: the mean of r_est / (duration a) (:461-466); climb rate: the
    # mean of s_est range / (duration a) (:469-478).  No valid estimate is
    # the reference's division by size() == 0: NaN, not a fabricated 0
    r_sum, r_n, r_any = _sum_count(r_est)
    s_sum, s_n, s_any = _sum_count(s_est)
    rot = torch.where(r_any, r_sum / (r_n * duration * a), float("nan"))
    vvel = torch.where(s_any, s_sum / s_n * range_ / (duration * a), float("nan"))

    rot = torch.where(rot.abs() > scalar(max_yaw_speed), float("nan"), rot)  # (:483-485)
    vvel = torch.where(vvel.abs() > scalar(max_vert_speed), float("nan"), vvel)  # (:487-489)
    return TranRotVvel(tran=tr, rot=rot, vvel=vvel)
