"""Runtime: messages, profiler, the OpticFlowNode, the serving layer
(:mod:`.serving` ServingLoop, :mod:`.fleet` FleetServer, :mod:`.fleet_feeder`
FleetFeeder), the stream harness (:mod:`.stream` FrameStream and
SyntheticScene), the flight simulator (:mod:`.flightsim`), the node's
native feeder (:mod:`.feeder`), the overlay renderer (:mod:`.viz`), the ROS
bridges (:mod:`.ros_bridge` RosBridge, :mod:`.ros2_bridge` Ros2Bridge) and
the bags (:mod:`.rosbag` ROS1, :mod:`.rosbag2` rosbag2).  The names mirror
the JAX package's ``runtime``; ``rospy`` and ``rclpy`` are imported only
when a bridge is built."""

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
from mrs_optic_flow_tpu_torch.runtime.ros2_bridge import Ros2Bridge  # noqa: F401
from mrs_optic_flow_tpu_torch.runtime.ros_bridge import RosBridge  # noqa: F401
from mrs_optic_flow_tpu_torch.runtime.rosbag import (  # noqa: F401
    BagReader,
    BagWriter,
    replay_bag,
)
from mrs_optic_flow_tpu_torch.runtime.rosbag2 import (  # noqa: F401
    Bag2Reader,
    Bag2Writer,
    replay_bag2,
)
from mrs_optic_flow_tpu_torch.runtime.serving import (  # noqa: F401
    ServingLoop,
    ServingRequest,
    ServingResult,
)
from mrs_optic_flow_tpu_torch.runtime.stream import FrameStream, SyntheticScene  # noqa: F401
