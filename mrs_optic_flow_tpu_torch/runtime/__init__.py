"""Runtime: messages, profiler, the OpticFlowNode, the serving layer
(:mod:`.serving` ServingLoop, :mod:`.fleet` FleetServer, :mod:`.fleet_feeder`
FleetFeeder), the stream harness (:mod:`.stream` FrameStream and
SyntheticScene), the flight simulator (:mod:`.flightsim`), the node's
native feeder (:mod:`.feeder`) and the overlay renderer (:mod:`.viz`).  The
names mirror the JAX package's ``runtime``; its ROS bridges and bags are not
ported (ROADMAP queue 1 item 9)."""

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
from mrs_optic_flow_tpu_torch.runtime.stream import FrameStream, SyntheticScene  # noqa: F401
