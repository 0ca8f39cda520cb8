"""Runtime: messages, profiler, the OpticFlowNode, and the serving layer
(:mod:`.serving` ServingLoop, :mod:`.fleet` FleetServer, :mod:`.fleet_feeder`
FleetFeeder).  The names mirror the JAX package's ``runtime``; its bridges,
bags and stream harness are not ported."""

from mrs_optic_flow_tpu_torch.runtime.msgs import (  # noqa: F401
    CameraInfo,
    Imu,
    Odometry,
    TwistWithCovarianceStamped,
)
from mrs_optic_flow_tpu_torch.runtime.fleet import FleetServer, FleetTick  # noqa: F401
from mrs_optic_flow_tpu_torch.runtime.fleet_feeder import FleetFeeder  # noqa: F401
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode  # noqa: F401
from mrs_optic_flow_tpu_torch.runtime.profiler import Profiler  # noqa: F401
from mrs_optic_flow_tpu_torch.runtime.serving import (  # noqa: F401
    ServingLoop,
    ServingRequest,
    ServingResult,
)
