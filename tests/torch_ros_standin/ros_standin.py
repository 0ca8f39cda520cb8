"""Stand-in ROS1 and ROS2 graph for running the node executable without ROS
(not a test module).

This directory goes on a child process's ``PYTHONPATH`` and on nothing else.
It holds ``rospy``, ``tf2_ros``, ``rclpy`` (with ``rclpy.duration``,
``rclpy.time`` and ``rclpy.qos``) and the message packages
``geometry_msgs``, ``std_msgs``, ``nav_msgs``, ``sensor_msgs`` and
``mrs_msgs``, written to the signatures of rospy 1.16 (noetic) and of
rclpy (humble), and this module, which they share.  The graph is one bag,
named by the environment:

- ``ROS_STANDIN_BAG``: a ROS1 ``.bag`` for ``rospy`` or a rosbag2 for
  ``rclpy``; its format picks the message flavour (ROS1: ``Header.seq``,
  ``rospy.Time`` stamps, ``CameraInfo.K``/``D``; ROS2: ``builtin_interfaces``
  stamps, ``k``/``d``).  The port's own ``runtime/rosbag.py`` and
  ``runtime/rosbag2.py`` read it.  ``rospy.wait_for_message`` and
  ``rclpy.spin_once`` answer the bag's first camera info; ``rospy.spin`` and
  ``rclpy.spin`` play every message through the subscribed callbacks in
  record order, time each image callback with ``time.perf_counter``, then
  return;
- ``ROS_STANDIN_OUT``: where the process writes, at exit, JSON lines: one
  per published message (topic, type, stamp and the twist's linear and
  angular fields and covariance, or the message's value), then one
  ``summary`` line (the
  image callbacks' wall times, the wall clock at the first image callback,
  the node name, the tf lookups, the modules ``jax``, ``yaml`` and ``cv2``
  blocked or loaded, and the port's kernel launch counters,
  ``<wrapper>.LAUNCHES`` of ``ops/cuda_kernels.py`` set to 0 when the
  messages start and read at exit, only if that module was imported);
- ``ROS_STANDIN_NO_MRS_MSGS=1``: ``mrs_msgs`` is not installed (its import
  raises ``ModuleNotFoundError``), so the bridges' ``ImportError`` branch
  runs and the node fails to start, as the reference's does.

Messages check their fields as the real ones do: ROS2 on every assignment
(rosidl's setters), ROS1 when published (genpy's serializer).
``tf2_ros.Buffer.lookup_transform`` answers the flights' camera mount (the
identity) once a ``TransformListener`` fills the buffer.

``no_jax/sitecustomize.py`` blocks ``jax``, ``yaml`` and ``cv2`` in the
process whose path holds it.  ``BAG_TO_BRIDGE`` and :func:`ros_messages`
are also what ``chip_smoke.py`` phase 16(l) feeds the in-process bridges.
"""

from __future__ import annotations

import array
import atexit
import json
import math
import numbers
import os
import struct
import sys
import time

import numpy as np

BAG_ENV = "ROS_STANDIN_BAG"
OUT_ENV = "ROS_STANDIN_OUT"
NO_MRS_ENV = "ROS_STANDIN_NO_MRS_MSGS"

#: this directory, the child process's PYTHONPATH
STANDIN = os.path.dirname(os.path.abspath(__file__))

#: the flights' bag topics -> the bridges' input topics
BAG_TO_BRIDGE = {"/camera_info": "camera_info_in", "/imu": "imu_in", "/odometry": "odometry_in",
                 "/height": "uav_height_in", "/image_raw": "camera_in"}

#: the flights' camera mount: the rotation the tf2 buffer answers (x, y, z, w)
MOUNT = (0.0, 0.0, 0.0, 1.0)


# --------------------------------------------------------------------------- #
# time                                                                        #
# --------------------------------------------------------------------------- #


class _TVal:
    """genpy's ``TVal``: ``secs`` and ``nsecs``, a float ``secs`` split."""

    def __init__(self, secs=0, nsecs=0):
        if not isinstance(secs, numbers.Integral):
            whole = int(secs)
            nsecs = int((secs - whole) * 1e9) + int(nsecs)
            secs = whole
        secs, nsecs = int(secs), int(nsecs)
        secs += nsecs // 1_000_000_000
        self.secs, self.nsecs = secs, nsecs % 1_000_000_000

    @classmethod
    def from_sec(cls, float_secs):
        secs = int(float_secs)
        return cls(secs, int((float_secs - secs) * 1e9))

    def to_sec(self) -> float:
        return float(self.secs) + float(self.nsecs) / 1e9

    def to_nsec(self) -> int:
        return self.secs * 1_000_000_000 + self.nsecs

    def __repr__(self):
        return f"{type(self).__name__}[{self.to_nsec()}]"


class RosTime(_TVal):
    """``rospy.Time`` (genpy.Time)."""


class RosDuration(_TVal):
    """``rospy.Duration`` (genpy.Duration)."""


# --------------------------------------------------------------------------- #
# messages                                                                    #
# --------------------------------------------------------------------------- #

_FLOATS = {"float32": "f", "float64": "d"}
_INTS = {"uint8": ("B", 0, 255), "int32": ("i", -2**31, 2**31 - 1), "uint32": ("I", 0, 2**32 - 1)}


def _definitions(ros2: bool) -> dict:
    """Type name -> its ``.msg`` text, as the flavour defines it."""
    stamp = "builtin_interfaces/Time stamp" if ros2 else "time stamp"
    d, k, r, p = ("d", "k", "r", "p") if ros2 else ("D", "K", "R", "P")
    xyz = "float64 x\nfloat64 y\nfloat64 z"
    return {
        "builtin_interfaces/Time": "int32 sec\nuint32 nanosec",
        "std_msgs/Header": ("" if ros2 else "uint32 seq\n") + stamp + "\nstring frame_id",
        "std_msgs/Float32": "float32 data",
        "std_msgs/Int32": "int32 data",
        "std_msgs/MultiArrayDimension": "string label\nuint32 size\nuint32 stride",
        "std_msgs/MultiArrayLayout": "std_msgs/MultiArrayDimension[] dim\nuint32 data_offset",
        "std_msgs/Float64MultiArray": "std_msgs/MultiArrayLayout layout\nfloat64[] data",
        "geometry_msgs/Vector3": xyz,
        "geometry_msgs/Point": xyz,
        "geometry_msgs/Quaternion": xyz + "\nfloat64 w",
        "geometry_msgs/Pose": "geometry_msgs/Point position\ngeometry_msgs/Quaternion orientation",
        "geometry_msgs/PoseWithCovariance": "geometry_msgs/Pose pose\nfloat64[36] covariance",
        "geometry_msgs/Twist": "geometry_msgs/Vector3 linear\ngeometry_msgs/Vector3 angular",
        "geometry_msgs/TwistWithCovariance": "geometry_msgs/Twist twist\nfloat64[36] covariance",
        "geometry_msgs/TwistWithCovarianceStamped":
            "std_msgs/Header header\ngeometry_msgs/TwistWithCovariance twist",
        "geometry_msgs/Transform": "geometry_msgs/Vector3 translation\ngeometry_msgs/Quaternion rotation",
        "geometry_msgs/TransformStamped":
            "std_msgs/Header header\nstring child_frame_id\ngeometry_msgs/Transform transform",
        "nav_msgs/Odometry": "std_msgs/Header header\nstring child_frame_id\n"
                             "geometry_msgs/PoseWithCovariance pose\ngeometry_msgs/TwistWithCovariance twist",
        "sensor_msgs/RegionOfInterest":
            "uint32 x_offset\nuint32 y_offset\nuint32 height\nuint32 width\nbool do_rectify",
        "sensor_msgs/Image": "std_msgs/Header header\nuint32 height\nuint32 width\nstring encoding\n"
                             "uint8 is_bigendian\nuint32 step\nuint8[] data",
        "sensor_msgs/CameraInfo": f"std_msgs/Header header\nuint32 height\nuint32 width\n"
                                  f"string distortion_model\nfloat64[] {d}\nfloat64[9] {k}\n"
                                  f"float64[9] {r}\nfloat64[12] {p}\nuint32 binning_x\nuint32 binning_y\n"
                                  f"sensor_msgs/RegionOfInterest roi",
        "sensor_msgs/Imu": "std_msgs/Header header\ngeometry_msgs/Quaternion orientation\n"
                           "float64[9] orientation_covariance\ngeometry_msgs/Vector3 angular_velocity\n"
                           "float64[9] angular_velocity_covariance\n"
                           "geometry_msgs/Vector3 linear_acceleration\n"
                           "float64[9] linear_acceleration_covariance",
        "mrs_msgs/Float64Stamped": "std_msgs/Header header\nfloat64 value",
        "mrs_msgs/ControlManagerDiagnostics": "std_msgs/Header header\nbool flying_normally\n"
                                              "bool motors\nstring active_tracker\nstring active_controller",
    }


class Message:
    """A message of one flavour.  ``_fields``: name -> (base type, size):
    a primitive name or a message class, size None (scalar), -1 (unbounded)
    or n (fixed).  Built from keywords like genpy's and rosidl's classes;
    unknown attributes are refused (both use ``__slots__``)."""

    _type = ""
    _fields: dict = {}
    _ros2 = False

    def __init__(self, **kwargs):
        unknown = set(kwargs) - set(self._fields)
        if unknown:
            raise TypeError(f"{self._type}: no fields {sorted(unknown)}")
        for name, (base, size) in self._fields.items():
            setattr(self, name, kwargs[name] if name in kwargs else _default(self, name, base, size))

    def __setattr__(self, name, value):
        if name not in self._fields:
            raise AttributeError(f"{self._type} has no field {name!r}")
        if self._ros2:  # rosidl's setters assert the type on every assignment
            value = _ros2_value(self._type, name, value, *self._fields[name])
        object.__setattr__(self, name, value)

    def check(self) -> None:
        """What genpy's serializer needs of every field: ROS1 raises here
        (at publish) where ROS2 raised at the assignment."""
        for name, (base, size) in self._fields.items():
            value = getattr(self, name)
            items = [value] if size is None else list(value)
            if size is not None and size >= 0 and len(items) != size:
                raise TypeError(f"{self._type}.{name}: {len(items)} items, {size} wanted")
            if base == "uint8" and size == -1 and isinstance(value, (bytes, bytearray)):
                continue
            for item in items:
                _ros1_check(self._type, name, base, item)


def _default(msg, name, base, size):
    if isinstance(base, type):
        return base() if size is None else []
    if size is None:
        if base == "time":
            return RosTime()
        if base == "string":
            return ""
        if base == "bool":
            return False
        w_one = msg._ros2 and msg._type == "geometry_msgs/Quaternion" and name == "w"
        return 1.0 if w_one else (0.0 if base in _FLOATS else 0)
    if msg._ros2:
        if size >= 0:
            return np.zeros(size, np.float64 if base in _FLOATS else np.int64)
        return array.array(_FLOATS.get(base) or _INTS[base][0])
    if base == "uint8" and size == -1:
        return b""
    return [0.0 if base in _FLOATS else 0] * max(size, 0)


def _fail(typ, name, what):
    raise AssertionError(f"The '{name}' field of {typ} must be {what}")


def _ros2_value(typ, name, value, base, size):
    """rosidl's setter: the value as stored, or AssertionError."""
    if isinstance(base, type):
        items = [value] if size is None else list(value)
        if not all(isinstance(v, base) for v in items):
            _fail(typ, name, f"of type {base._type}")
        return value if size is None else items
    if size is None:
        if base in _FLOATS:
            if not isinstance(value, float):
                _fail(typ, name, "of type 'float'")
        elif base == "bool":
            if not isinstance(value, bool):
                _fail(typ, name, "of type 'bool'")
        elif base == "string":
            if not isinstance(value, str):
                _fail(typ, name, "of type 'str'")
        else:
            lo, hi = _INTS[base][1:]
            if not isinstance(value, int) or not lo <= value <= hi:
                _fail(typ, name, f"an integer in [{lo}, {hi}]")
        return value
    if size >= 0:  # a fixed array: a numpy array
        if isinstance(value, np.ndarray):
            if value.dtype != np.float64 or value.size != size:
                _fail(typ, name, f"a float64 numpy array of {size}")
            return value
        if len(value) != size or not all(isinstance(v, float) for v in value):
            _fail(typ, name, f"a sequence of {size} floats")
        return np.array(value, np.float64)
    code = _FLOATS.get(base) or _INTS[base][0]
    if isinstance(value, array.array):
        if value.typecode != code:
            _fail(typ, name, f"an array.array of typecode {code!r}")
        return value
    try:
        return array.array(code, value)
    except (TypeError, OverflowError):
        _fail(typ, name, f"a sequence of {base}")


def _ros1_check(typ, name, base, value):
    if isinstance(base, type):
        if not isinstance(value, base):
            raise TypeError(f"{typ}.{name}: {type(value).__name__}, {base._type} wanted")
        value.check()
    elif base == "time":
        if not isinstance(value, _TVal):
            raise TypeError(f"{typ}.{name}: {type(value).__name__} has no secs/nsecs")
    elif base == "string":
        if not isinstance(value, str):
            raise TypeError(f"{typ}.{name}: {value!r} is not a str")
    elif base in _FLOATS:
        if not isinstance(value, numbers.Real) or isinstance(value, bool):
            raise TypeError(f"{typ}.{name}: {value!r} is not a number")
    elif not isinstance(value, numbers.Integral):
        raise TypeError(f"{typ}.{name}: {value!r} is not an integer")


_CLASSES: dict = {}


def message_classes(ros2: bool) -> dict:
    """Type name (``"sensor_msgs/Image"``) -> its class in the flavour."""
    if ros2 in _CLASSES:
        return _CLASSES[ros2]
    defs = _definitions(ros2)
    classes: dict = {}

    def build(type_name):
        if type_name in classes:
            return classes[type_name]
        fields = {}
        for line in defs[type_name].splitlines():
            spec, name = line.split()
            base, size = spec, None
            if spec.endswith("]"):
                base, _, n = spec[:-1].partition("[")
                size = int(n) if n else -1
            fields[name] = (build(base) if "/" in base else base, size)
        cls = type(type_name.split("/")[1], (Message,), {
            "_type": type_name, "_fields": fields, "_ros2": ros2,
            "__module__": type_name.split("/")[0] + ".msg"})
        classes[type_name] = cls
        return cls

    for type_name in defs:
        build(type_name)
    _CLASSES[ros2] = classes
    return classes


def package(name: str) -> dict:
    """The classes of message package ``name`` in the bag's flavour: what
    ``<name>/msg.py`` exports."""
    prefix = name + "/"
    return {t.split("/")[1]: cls for t, cls in message_classes(flavour_ros2()).items()
            if t.startswith(prefix)}


# --------------------------------------------------------------------------- #
# the bag                                                                     #
# --------------------------------------------------------------------------- #


class _Reader:
    """Little-endian cursor over a message: ROS1 serialization, or CDR with
    its 4-byte encapsulation header and primitives aligned to their size."""

    def __init__(self, raw: bytes, cdr: bool):
        self.raw, self.cdr = raw, cdr
        self.off = 4 if cdr else 0

    def take(self, fmt: str):
        size = struct.calcsize("<" + fmt)
        if self.cdr:
            self.off += -(self.off - 4) % size
        (v,) = struct.unpack_from("<" + fmt, self.raw, self.off)
        self.off += size
        return v

    def block(self, n: int) -> bytes:
        v = self.raw[self.off:self.off + n]
        self.off += n
        return v

    def string(self) -> str:
        n = self.take("I")  # CDR counts the terminating NUL
        text = self.block(n)
        return (text[:-1] if self.cdr and n else text).decode()


def deserialize(cls, reader: _Reader):
    """A message of ``cls`` read field by field from ``reader``."""
    values = {}
    for name, (base, size) in cls._fields.items():
        if size == -1:
            n = reader.take("I")
        elif size is not None:
            n = size
        if isinstance(base, type):
            v = (deserialize(base, reader) if size is None
                 else [deserialize(base, reader) for _ in range(n)])
        elif base == "time":
            v = RosTime(reader.take("I"), reader.take("I"))
        elif base == "string":
            v = reader.string()
        elif base == "bool":
            v = bool(reader.take("B"))
        elif base == "uint8" and size == -1:
            data = reader.block(n)
            v = array.array("B", data) if cls._ros2 else data
        else:
            code = _FLOATS.get(base) or _INTS[base][0]
            v = reader.take(code) if size is None else [reader.take(code) for _ in range(n)]
        values[name] = v
    return cls(**values)


def _is_rosbag2(path: str) -> bool:
    from mrs_optic_flow_tpu_torch.runtime.rosbag2 import is_rosbag2

    return is_rosbag2(path)


def ros_messages(path: str, ros2=None) -> list:
    """(bridge input topic, message) for every message of the bag at
    ``path`` (a ROS1 bag or a rosbag2), in record order, each a message of
    the ROS2 flavour if ``ros2`` else of ROS1 (default: the bag's own)."""
    from mrs_optic_flow_tpu_torch.runtime import rosbag, rosbag2

    bag2 = _is_rosbag2(path)
    ros2 = bag2 if ros2 is None else ros2
    classes = message_classes(ros2)
    reader_cls = rosbag2.Bag2Reader if bag2 else rosbag.BagReader
    out = []
    with reader_cls(path) as reader:
        for _, topic, type_name, raw in reader.messages():
            cls = message_classes(bag2)[type_name.replace("/msg/", "/")]
            msg = deserialize(cls, _Reader(raw, cdr=bag2))
            if ros2 != bag2:
                msg = convert(msg, classes)
            out.append((BAG_TO_BRIDGE[topic], msg))
    return out


def convert(msg, classes: dict):
    """``msg`` as the same message of the other flavour (``classes``):
    stamps, the calibration fields' case and ``Header.seq``."""
    cls = classes[msg._type]
    values = {}
    src = {n.lower(): n for n in msg._fields}
    for name, (base, size) in cls._fields.items():
        if name.lower() not in src:
            continue  # Header.seq, which ROS2 does not have
        v = getattr(msg, src[name.lower()])
        if base == "time" or (isinstance(base, type) and base._type == "builtin_interfaces/Time"):
            ns = v.to_nsec() if isinstance(v, _TVal) else v.sec * 1_000_000_000 + v.nanosec
            v = RosTime(0, ns) if base == "time" else base(sec=ns // 10**9, nanosec=ns % 10**9)
        elif isinstance(base, type):
            v = convert(v, classes) if size is None else [convert(x, classes) for x in v]
        elif size is not None:
            v = ((array.array(_FLOATS.get(base) or _INTS[base][0], v) if size == -1
                  else np.asarray(v, np.float64)) if cls._ros2
                 else (bytes(v) if base == "uint8" and size == -1 else [float(x) for x in v]))
        values[name] = v
    return cls(**values)


def stamp_of(msg) -> float:
    """``header.stamp`` in seconds, either flavour."""
    st = msg.header.stamp
    return st.to_sec() if isinstance(st, _TVal) else st.sec + st.nanosec * 1e-9


# --------------------------------------------------------------------------- #
# the graph                                                                   #
# --------------------------------------------------------------------------- #


def flavour_ros2() -> bool:
    """True if ``ROS_STANDIN_BAG`` names a rosbag2, False for a ROS1 bag."""
    path = os.environ.get(BAG_ENV)
    if not path or not os.path.exists(path):
        raise RuntimeError(f"{BAG_ENV} names no bag: {path!r}")
    return _is_rosbag2(path)


class Endpoint:
    """A publisher or subscription: the name asked for, its class, its
    callback."""

    def __init__(self, graph, name: str, data_class, callback=None):
        if not (isinstance(data_class, type) and issubclass(data_class, Message)):
            raise TypeError(f"{name}: {data_class!r} is not a message class")
        self.graph, self.name, self.data_class, self.callback = graph, name, data_class, callback

    def publish(self, msg) -> None:
        if not isinstance(msg, self.data_class):
            raise TypeError(f"{self.name}: published a {type(msg).__name__}, "
                            f"{self.data_class._type} advertised")
        if not msg._ros2:
            msg.check()
        self.graph.record(self.name, msg)


class Graph:
    """The bag's messages, the endpoints, what the process published and the
    image callbacks' wall times; written to ``ROS_STANDIN_OUT`` at exit."""

    def __init__(self, ros2: bool):
        path = os.environ.get(BAG_ENV)
        if flavour_ros2() != ros2:
            raise RuntimeError(f"{BAG_ENV}={path}: a {'rosbag2' if not ros2 else 'ROS1 bag'} "
                               f"for {'rclpy' if ros2 else 'rospy'}")
        self.ros2 = ros2
        self.prefix = "~/" if ros2 else "~"
        self.messages = ros_messages(path)
        self.subs, self.pubs, self.published = [], [], []
        self.image_s, self.first_image_wall = [], None
        self.tf_lookups, self.node_name, self.launches_reset = set(), None, False
        self.camera_info_answered = False
        atexit.register(self.write)

    def first(self, topic: str):
        for name, msg in self.messages:
            if name == topic:
                return msg
        return None

    def deliver(self, sub, msg) -> None:
        if not isinstance(msg, sub.data_class):
            raise TypeError(f"{sub.name}: subscribed as {sub.data_class._type}, the graph "
                            f"carries {msg._type}")
        if sub.name != self.prefix + "camera_in":
            sub.callback(msg)
            return
        if self.first_image_wall is None:
            self.first_image_wall = time.time()
        t0 = time.perf_counter()
        sub.callback(msg)
        self.image_s.append(time.perf_counter() - t0)

    def play(self) -> None:
        """Every message through the subscriptions of its topic, in record
        order, the kernel launch counters set to 0 just before."""
        ck = sys.modules.get("mrs_optic_flow_tpu_torch.ops.cuda_kernels")
        for fn in _wrappers(ck).values():
            fn.LAUNCHES = 0
        self.launches_reset = ck is not None
        for topic, msg in self.messages:
            for sub in [s for s in self.subs if s.name == self.prefix + topic]:
                self.deliver(sub, msg)

    def answer_camera_info(self, name: str, data_class):
        """The bag's first camera info, for ``wait_for_message``/``spin_once``."""
        if name != self.prefix + "camera_info_in":
            return None
        msg = self.first("camera_info_in")
        if msg is not None and not isinstance(msg, data_class):
            raise TypeError(f"{name}: asked for {data_class._type}, the graph carries {msg._type}")
        return msg

    def record(self, name: str, msg) -> None:
        row = {"topic": name[len(self.prefix):] if name.startswith(self.prefix) else name,
               "type": msg._type}
        if "header" in msg._fields:
            row["stamp"] = stamp_of(msg)
        if msg._type == "geometry_msgs/TwistWithCovarianceStamped":
            tw = msg.twist.twist
            row["linear"] = [tw.linear.x, tw.linear.y, tw.linear.z]
            row["angular"] = [tw.angular.x, tw.angular.y, tw.angular.z]
            row["covariance"] = [float(v) for v in msg.twist.covariance]
        elif msg._type == "geometry_msgs/Vector3":
            row["value"] = [msg.x, msg.y, msg.z]
        else:
            row["value"] = [float(v) for v in msg.data] if "layout" in msg._fields else msg.data
        self.published.append(row)

    def write(self) -> None:
        out = os.environ.get(OUT_ENV)
        if not out:
            return
        ck = sys.modules.get("mrs_optic_flow_tpu_torch.ops.cuda_kernels")
        summary = {
            "summary": True,
            "image_callback_s": self.image_s,
            "first_image_wall": self.first_image_wall,
            "node_name": self.node_name,
            "tf_lookups": sorted(self.tf_lookups),
            "blocked": {m: sys.modules.get(m, 0) is None for m in ("jax", "yaml", "cv2")},
            "loaded": sorted(m for m in sys.modules if m.split(".")[0] in (
                "jax", "jaxlib", "yaml", "cv2", "mrs_optic_flow_tpu") and sys.modules[m] is not None),
            "launches": ({name: fn.LAUNCHES for name, fn in _wrappers(ck).items()}
                         if self.launches_reset else None),
        }
        with open(out, "w") as fh:
            for row in self.published:
                fh.write(json.dumps(row) + "\n")
            fh.write(json.dumps(summary) + "\n")


def _wrappers(ck) -> dict:
    """The kernel wrappers of ``ops/cuda_kernels.py`` (those with a
    ``LAUNCHES`` count), none if it was not imported."""
    if ck is None:
        return {}
    return {name: fn for name, fn in vars(ck).items()
            if callable(fn) and isinstance(getattr(fn, "LAUNCHES", None), int)}


_GRAPH = {}


def graph(ros2: bool) -> Graph:
    """The process's graph, made at the first call."""
    if ros2 not in _GRAPH:
        _GRAPH[ros2] = Graph(ros2)
    return _GRAPH[ros2]


def environment(bag: str, out: str, *, block_jax: bool = True, mrs_msgs: bool = True,
                base=None) -> dict:
    """A child process's environment: ``base`` (default ``os.environ``) with
    ``PYTHONPATH`` this directory and nothing else (and ``no_jax``, which
    blocks jax, yaml and cv2, when ``block_jax``), the bag and the output
    path, and ``mrs_msgs`` left out unless ``mrs_msgs``."""
    env = dict(os.environ if base is None else base)
    env["PYTHONPATH"] = os.pathsep.join([STANDIN] + ([os.path.join(STANDIN, "no_jax")]
                                                     if block_jax else []))
    env[BAG_ENV], env[OUT_ENV] = bag, out
    env.pop(NO_MRS_ENV, None)
    if not mrs_msgs:
        env[NO_MRS_ENV] = "1"
    return env


def read_output(path: str) -> tuple:
    """(published rows, summary) of a ``ROS_STANDIN_OUT`` file."""
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    if not rows or not rows[-1].get("summary"):
        raise ValueError(f"{path}: no summary line")
    return rows[:-1], rows[-1]


def twists(rows: list) -> dict:
    """topic -> {stamp rounded to 1 us: (linear x, linear y)} of the
    published velocity twists."""
    out: dict = {}
    for row in rows:
        if row["topic"] in ("velocity_out", "velocity_out_longrange") and "linear" in row:
            out.setdefault(row["topic"], {})[round(row["stamp"], 6)] = tuple(row["linear"][:2])
    return out


def twist_diff(a: dict, b: dict) -> float:
    """Largest difference [m/s] between two :func:`twists` maps; both must
    hold the same topics and stamps, at least one twist."""
    if a.keys() != b.keys() or any(a[t].keys() != b[t].keys() for t in a) or not a:
        raise AssertionError(f"twist stamps differ: {({t: sorted(v) for t, v in a.items()})} "
                             f"against {({t: sorted(v) for t, v in b.items()})}")
    worst = 0.0
    for topic in a:
        for stamp in a[topic]:
            d = np.abs(np.subtract(a[topic][stamp], b[topic][stamp]))
            if not np.all(np.isfinite(d)):
                return math.inf
            worst = max(worst, float(d.max()))
    return worst
