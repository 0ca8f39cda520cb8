"""Vector filtering and statistics toolkit (``src/utilityFunctions.cpp``,
``include/utilityFunctions.h``): the allsac / ransac means, the bounds, the
speed statistics and ``estimateTranRotVvel``, with the names of
:mod:`mrs_optic_flow_tpu.filters`."""

from mrs_optic_flow_tpu_torch.filters.allsac import (  # noqa: F401
    allsac_mean,
    allsac_mean_1d,
    bound_abs_mask,
    bound_radius_mask,
    point_mean,
    ransac_mean,
    rotate_2d,
)
from mrs_optic_flow_tpu_torch.filters.stats import SpeedBox, StatData, analyze_speeds  # noqa: F401
from mrs_optic_flow_tpu_torch.filters.tran_rot_vvel import (  # noqa: F401
    TranRotVvel,
    estimate_tran_rot_vvel,
)
