"""Geometry: undistortion, RANSAC homography, decomposition, getRT and
get2DT, per pair and batched (:mod:`.batched`), with the names that
:mod:`mrs_optic_flow_tpu.geometry` exports."""

from mrs_optic_flow_tpu_torch.geometry.rotations import (  # noqa: F401
    matrix_from_quat,
    quat_angle,
    quat_axis_angle,
    quat_from_axis_angle,
    quat_from_matrix,
    quat_from_rpy,
    quat_inverse,
    quat_rotate,
    rpy_from_matrix,
)
from mrs_optic_flow_tpu_torch.geometry.undistort import undistort_points  # noqa: F401
from mrs_optic_flow_tpu_torch.geometry.homography import (  # noqa: F401
    decompose_homography,
    find_homography_ransac,
)
from mrs_optic_flow_tpu_torch.geometry.motion import (  # noqa: F401
    get_2dt,
    get_inliers,
    get_rt,
    grid_centers,
)
