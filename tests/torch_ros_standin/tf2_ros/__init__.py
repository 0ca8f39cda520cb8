"""Stand-in ``tf2_ros``: ``Buffer``, ``TransformListener`` and the lookup
exceptions, to the signatures of the flavour the bag picks (ROS1 tf2_ros
0.7 or ROS2 humble).  A buffer answers only once a listener fills it, and
then with the flights' camera mount (``ros_standin.MOUNT``)."""

import ros_standin

_ROS2 = ros_standin.flavour_ros2()


class TransformException(Exception):
    pass


class LookupException(TransformException):
    pass


def _check_time(time, timeout):
    if _ROS2:
        from rclpy.duration import Duration
        from rclpy.time import Time

        if not isinstance(time, Time) or not (timeout is None or isinstance(timeout, Duration)):
            raise TypeError(f"lookup_transform takes rclpy.time.Time and rclpy.duration.Duration, "
                            f"got {time!r}, {timeout!r}")
    elif not isinstance(time, ros_standin.RosTime) or not isinstance(timeout, ros_standin.RosDuration):
        raise TypeError(f"lookup_transform takes rospy.Time and rospy.Duration, got {time!r}, {timeout!r}")


class Buffer:
    if _ROS2:
        def __init__(self, cache_time=None, node=None):
            self.filled = False
    else:
        def __init__(self, cache_time=None, debug=True):
            self.filled = False

    def lookup_transform(self, target_frame, source_frame, time, timeout=None):
        if timeout is None and not _ROS2:
            timeout = ros_standin.RosDuration(0.0)
        _check_time(time, timeout)
        if not self.filled:
            raise LookupException(f'"{target_frame}" passed to lookupTransform argument target_frame '
                                  "does not exist.")
        ros_standin.graph(_ROS2).tf_lookups.add((target_frame, source_frame))
        classes = ros_standin.message_classes(_ROS2)
        out = classes["geometry_msgs/TransformStamped"](child_frame_id=source_frame)
        out.header.frame_id = target_frame
        rot = out.transform.rotation
        rot.x, rot.y, rot.z, rot.w = (float(v) for v in ros_standin.MOUNT)
        return out


class TransformListener:
    if _ROS2:
        def __init__(self, buffer, node, *, spin_thread=False, qos=None, static_qos=None):
            from rclpy.node import Node

            if not isinstance(node, Node):
                raise TypeError(f"TransformListener needs an rclpy node, got {node!r}")
            self.buffer = buffer
            buffer.filled = True
    else:
        def __init__(self, buffer, queue_size=None, buff_size=65536, tcp_nodelay=False):
            import rospy

            # the listener subscribes /tf and /tf_static: init_node first
            if rospy.get_name() == "/unnamed":
                raise rospy.ROSInitException("tf2_ros.TransformListener before rospy.init_node()")
            self.buffer = buffer
            buffer.filled = True
