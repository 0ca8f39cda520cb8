"""Stand-in ``rospy`` (1.16, noetic): the calls a node makes, to their
signatures, over the stand-in graph of ``ros_standin.py``.  Stricter than
rospy in one place: a ``~`` name resolved before ``init_node`` raises
(rospy resolves it against ``/unnamed`` and the node never connects)."""

import sys
import time

import ros_standin

Time = ros_standin.RosTime
Duration = ros_standin.RosDuration


class ROSException(Exception):
    pass


class ROSInitException(ROSException):
    pass


_state = {"name": None}


def _graph():
    return ros_standin.graph(False)


def _resolve(name: str) -> str:
    if name.startswith("~") and _state["name"] is None:
        raise ROSInitException(f"{name!r} resolved before rospy.init_node()")
    return name


def init_node(name, argv=None, anonymous=False, log_level=None, disable_rostime=False,
              disable_rosout=False, disable_signals=False, xmlrpc_port=0, tcpros_port=0):
    if _state["name"] is not None:
        raise ROSException("rospy.init_node() has already been called with different arguments: "
                           f"{_state['name']}")
    argv = sys.argv if argv is None else argv
    remapped = [a.split(":=", 1)[1] for a in argv if a.startswith("__name:=")]
    _state["name"] = remapped[-1] if remapped else name
    _graph().node_name = _state["name"]


def get_name() -> str:
    return "/" + (_state["name"] or "unnamed")


class Publisher(ros_standin.Endpoint):
    def __init__(self, name, data_class, subscriber_listener=None, tcp_nodelay=False, latch=False,
                 headers=None, queue_size=None):
        super().__init__(_graph(), _resolve(name), data_class)
        self.graph.pubs.append(self)


class Subscriber(ros_standin.Endpoint):
    def __init__(self, name, data_class, callback=None, callback_args=None, queue_size=None,
                 buff_size=65536, tcp_nodelay=False):
        super().__init__(_graph(), _resolve(name), data_class, callback)
        self.graph.subs.append(self)


def wait_for_message(topic, topic_type, timeout=None):
    if _state["name"] is None:
        raise ROSInitException("client code must call rospy.init_node() first")
    msg = _graph().answer_camera_info(_resolve(topic), topic_type)
    if msg is None:
        raise ROSException(f"timeout exceeded while waiting for message on topic {topic}")
    return msg


def spin():
    """Play the bag through the subscribers, then return (as rospy.spin
    returns at shutdown)."""
    if _state["name"] is None:
        raise ROSInitException("client code must call rospy.init_node() first")
    _graph().play()


def _log(level, stream):
    def log(msg, *args, **kwargs):
        print(f"[{level}] [{time.time():.6f}]: {msg % args if args else msg}", file=stream, flush=True)
    return log


loginfo = _log("INFO", sys.stdout)
logwarn = _log("WARN", sys.stderr)
logerr = _log("ERROR", sys.stderr)
