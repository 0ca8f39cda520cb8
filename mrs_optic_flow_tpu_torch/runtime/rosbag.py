"""Offline ROS1 rosbag replay — no ROS installation required.

The port's own copy of :mod:`mrs_optic_flow_tpu.runtime.rosbag` (stdlib and
numpy; the port imports nothing of the JAX package): the same reader,
decoders, encoders, writer and replay loop, driving the port's node.  Its
writer's bytes equal the JAX package's for the same writes.

A reference user's flight data lives in rosbags (the reference is driven
from recorded ``bluefox_optflow/image_raw`` + odometry topics on a live
graph, ``src/optic_flow.cpp:1049-1063``; rosbag is the stock way those
flights are archived).  This module replays such bags straight into
:class:`~mrs_optic_flow_tpu_torch.runtime.node.OpticFlowNode` without ROS:

- :class:`BagReader` parses the rosbag **2.0** container format
  (`#ROSBAG V2.0`): record framing, connection records, and chunks with
  ``none``/``bz2`` compression (``lz4`` when the optional ``lz4.frame``
  module exists).  Index records are skipped — the reader streams the
  chunks, which rosbag writes in record order.
- Message payloads are decoded with small struct cursors for exactly the
  types the node consumes (little-endian ROS1 serialization):
  ``sensor_msgs/Image`` + ``CompressedImage`` (the latter via cv2),
  ``sensor_msgs/CameraInfo``, ``sensor_msgs/Imu``, ``nav_msgs/Odometry``,
  and ``mrs_msgs/Float64Stamped`` (the height topic).  Decoders build
  duck-typed message objects and reuse the conformance-tested converters
  in :mod:`.ros_bridge` (``decode_image``, ``from_camera_info``, ...).
- :func:`replay_bag` maps topics to node callbacks (auto-detected by type,
  overridable), dispatches in record order, and synthesizes level-flight
  IMU/odometry/height defaults for roles the bag does not carry — the same
  convention as the ``.ofrec`` replay path (``__main__.py``).

The CLI accepts it directly: ``python -m mrs_optic_flow_tpu_torch --replay
flight.bag``.
"""

from __future__ import annotations

import bz2
import struct
from types import SimpleNamespace
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from mrs_optic_flow_tpu_torch.runtime import ros_bridge as _rb
from mrs_optic_flow_tpu_torch.runtime.msgs import Float64Stamped

_MAGIC = b"#ROSBAG V2.0\n"

# record opcodes (rosbag 2.0)
_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONNECTION = 0x07


class BagFormatError(ValueError):
    """The file is not a parseable rosbag 2.0 stream."""


# ------------------------------------------------------------------ #
# container parsing                                                   #
# ------------------------------------------------------------------ #


def _parse_header(buf: bytes) -> Dict[str, bytes]:
    """A rosbag record header: ``u32 len | name=value`` fields."""
    fields: Dict[str, bytes] = {}
    off = 0
    while off < len(buf):
        if off + 4 > len(buf):
            raise BagFormatError("truncated header field length")
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = bytes(buf[off : off + flen])  # bytes() also accepts memoryview
        if len(field) != flen:
            raise BagFormatError("truncated header field")
        off += flen
        name, sep, value = field.partition(b"=")
        if not sep:
            raise BagFormatError(f"malformed header field {field[:40]!r}")
        fields[name.decode("latin-1")] = value
    return fields


def _iter_records(buf: bytes, off: int = 0) -> Iterator[Tuple[Dict[str, bytes], bytes]]:
    """Yield ``(header_fields, data)`` records from ``buf[off:]``."""
    n = len(buf)
    while off < n:
        if off + 4 > n:
            raise BagFormatError("truncated record (header length)")
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off : off + hlen])
        off += hlen
        if off + 4 > n:
            raise BagFormatError("truncated record (data length)")
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off : off + dlen]
        if len(data) != dlen:
            raise BagFormatError("truncated record data")
        off += dlen
        yield header, data


def _decompress(compression: bytes, data: bytes) -> bytes:
    if compression in (b"none", b""):
        return data
    if compression == b"bz2":
        return bz2.decompress(data)
    if compression == b"lz4":
        try:
            import lz4.frame  # noqa: PLC0415 — optional
        except ImportError as e:
            raise BagFormatError(
                "bag uses lz4 chunk compression and the lz4 module is not "
                "available; re-record with --bz2 or install lz4"
            ) from e
        return lz4.frame.decompress(data)
    raise BagFormatError(f"unknown chunk compression {compression!r}")


class BagReader:
    """Stream ``(time_s, topic, type_name, raw_message_bytes)`` from a
    rosbag 2.0 file.  Connections are resolved as they appear (rosbag
    writes each connection record before the first message that uses it,
    both inside and outside chunks)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")  # noqa: SIM115 — backs the mmap below
        magic = self._fh.read(len(_MAGIC))
        if magic != _MAGIC:
            self._fh.close()
            raise BagFormatError(
                f"{path}: not a rosbag 2.0 file (magic {magic!r}; v1 "
                "bags need `rosbag fix` first)"
            )
        # mmap, not read(): flight bags are GBs and replay touches each
        # chunk once — no reason to hold the whole file resident
        import mmap  # noqa: PLC0415

        try:
            whole = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
            self._buf: Any = memoryview(whole)[len(_MAGIC):]
        except (ValueError, OSError):  # empty file / exotic fs: plain bytes
            self._fh.seek(len(_MAGIC))
            self._buf = self._fh.read()
        #: conn id -> (topic, type name)
        self.connections: Dict[int, Tuple[str, str]] = {}

    def _note_connection(self, header: Dict[str, bytes], data: bytes) -> None:
        (conn,) = struct.unpack("<I", header["conn"])
        conn_hdr = _parse_header(data)
        topic = header.get("topic", conn_hdr.get("topic", b"")).decode()
        type_name = conn_hdr.get("type", b"").decode()
        self.connections[conn] = (topic, type_name)

    def messages(self) -> Iterator[Tuple[float, str, str, bytes]]:
        for header, data in _iter_records(self._buf):
            op = header.get("op", b"\x00")[0]
            if op == _OP_CONNECTION:
                self._note_connection(header, data)
            elif op == _OP_CHUNK:
                chunk = _decompress(header.get("compression", b"none"), data)
                for chdr, cdata in _iter_records(chunk):
                    cop = chdr.get("op", b"\x00")[0]
                    if cop == _OP_CONNECTION:
                        self._note_connection(chdr, cdata)
                    elif cop == _OP_MSG:
                        yield self._msg(chdr, cdata)
            elif op == _OP_MSG:
                yield self._msg(header, data)
            # _OP_BAGHDR / _OP_INDEX / _OP_CHUNKINFO: skipped (index-free scan)

    def _msg(self, header: Dict[str, bytes], data: bytes):
        (conn,) = struct.unpack("<I", header["conn"])
        secs, nsecs = struct.unpack("<II", header["time"])
        if conn not in self.connections:
            raise BagFormatError(f"message for unknown connection {conn}")
        topic, type_name = self.connections[conn]
        return secs + nsecs * 1e-9, topic, type_name, bytes(data)

    def topics_by_type(self) -> Dict[str, List[str]]:
        """``type name -> [topic, ...]``.

        rosbag repeats every connection record at top level after the last
        chunk (the index section), so the normal case never decompresses a
        chunk here; bags missing that section (e.g. unindexed/crashed
        recordings) fall back to the full scan.
        """
        if not self.connections:
            for header, data in _iter_records(self._buf):
                if header.get("op", b"\x00")[0] == _OP_CONNECTION:
                    self._note_connection(header, data)
        if not self.connections:
            for _ in self.messages():  # deep scan (decompresses chunks)
                pass
        out: Dict[str, List[str]] = {}
        for topic, type_name in self.connections.values():
            out.setdefault(type_name, [])
            if topic not in out[type_name]:
                out[type_name].append(topic)
        return out

    def close(self) -> None:
        buf, self._buf = self._buf, b""
        if isinstance(buf, memoryview):
            mm = buf.obj
            buf.release()
            try:
                mm.close()
            except BufferError:
                # an exception unwinding through messages() can keep
                # memoryview slices alive in traceback frames; the map is
                # released when they are GC'd — never mask the real error
                pass
        self._fh.close()

    def __enter__(self) -> "BagReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------ #
# ROS1 message deserialization (little-endian)                        #
# ------------------------------------------------------------------ #


class _Cur:
    """Struct cursor over a serialized ROS1 message."""

    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def f64s(self, n: int) -> Tuple[float, ...]:
        v = struct.unpack_from(f"<{n}d", self.buf, self.off)
        self.off += 8 * n
        return v

    def string(self) -> str:
        n = self.u32()
        v = self.buf[self.off : self.off + n]
        self.off += n
        return v.decode("utf-8", "replace")

    def raw(self, n: int) -> bytes:
        v = self.buf[self.off : self.off + n]
        self.off += n
        return v

    def header(self) -> float:
        """std_msgs/Header -> stamp in seconds (seq/frame_id skipped)."""
        self.u32()  # seq
        secs, nsecs = self.u32(), self.u32()
        self.string()  # frame_id
        return secs + nsecs * 1e-9

    def xyz(self) -> SimpleNamespace:
        return SimpleNamespace(x=self.f64(), y=self.f64(), z=self.f64())

    def quat(self) -> SimpleNamespace:
        return SimpleNamespace(x=self.f64(), y=self.f64(), z=self.f64(), w=self.f64())


def _hdr_ns(stamp: float) -> SimpleNamespace:
    return SimpleNamespace(stamp=stamp)


def decode_image_msg(buf: bytes):
    """sensor_msgs/Image -> :class:`ImageMsg` (via the bridge's stride- and
    encoding-aware ``decode_image``)."""
    c = _Cur(buf)
    stamp = c.header()
    height, width = c.u32(), c.u32()
    encoding = c.string()
    c.u8()  # is_bigendian (ROS1 serialization itself is always LE)
    step = c.u32()
    data = c.raw(c.u32())
    return _rb.decode_image(
        SimpleNamespace(
            header=_hdr_ns(stamp), height=height, width=width,
            encoding=encoding, step=step, data=data,
        )
    )


def decode_compressed_image_msg(buf: bytes):
    """sensor_msgs/CompressedImage -> :class:`ImageMsg` — jpeg/png decode
    needs cv2 (present in OpenCV-equipped environments; the reference
    pipeline assumes OpenCV anyway)."""
    c = _Cur(buf)
    stamp = c.header()
    fmt = c.string()
    data = c.raw(c.u32())
    try:
        import cv2  # noqa: PLC0415 — optional
        import numpy as np  # noqa: PLC0415
    except ImportError as e:
        raise BagFormatError(
            f"CompressedImage ({fmt!r}) in the bag needs cv2 to decode"
        ) from e
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise BagFormatError(f"cv2 could not decode CompressedImage ({fmt!r})")
    from mrs_optic_flow_tpu_torch.runtime.msgs import ImageMsg  # noqa: PLC0415

    return ImageMsg(stamp=stamp, data=img[..., :3] if img.ndim == 3 else img)


def decode_camera_info_msg(buf: bytes):
    """sensor_msgs/CameraInfo -> :class:`CameraInfo`."""
    c = _Cur(buf)
    stamp = c.header()
    c.u32(), c.u32()  # height, width
    c.string()  # distortion_model
    d = list(c.f64s(c.u32()))
    k = list(c.f64s(9))
    c.f64s(9)  # R
    c.f64s(12)  # P
    binning_x = c.u32()
    return _rb.from_camera_info(
        SimpleNamespace(header=_hdr_ns(stamp), K=k, D=d, binning_x=binning_x)
    )


def decode_imu_msg(buf: bytes):
    """sensor_msgs/Imu -> :class:`Imu`."""
    c = _Cur(buf)
    stamp = c.header()
    orientation = c.quat()
    c.f64s(9)
    angular_velocity = c.xyz()
    # covariance + linear acceleration: not consumed by the node
    return _rb.from_imu(
        SimpleNamespace(
            header=_hdr_ns(stamp),
            orientation=orientation,
            angular_velocity=angular_velocity,
        )
    )


def decode_odometry_msg(buf: bytes):
    """nav_msgs/Odometry -> :class:`Odometry`."""
    c = _Cur(buf)
    stamp = c.header()
    c.string()  # child_frame_id
    c.xyz()  # pose.pose.position
    orientation = c.quat()
    c.f64s(36)
    linear = c.xyz()
    angular = c.xyz()
    return _rb.from_odometry(
        SimpleNamespace(
            header=_hdr_ns(stamp),
            pose=SimpleNamespace(pose=SimpleNamespace(orientation=orientation)),
            twist=SimpleNamespace(
                twist=SimpleNamespace(linear=linear, angular=angular)
            ),
        )
    )


def decode_float64_stamped_msg(buf: bytes) -> Float64Stamped:
    """mrs_msgs/Float64Stamped (the height topic,
    ``src/optic_flow.cpp:1274-1301``)."""
    c = _Cur(buf)
    stamp = c.header()
    return Float64Stamped(stamp=stamp, value=c.f64())


def decode_tf_message(buf: bytes) -> List[Tuple[str, str, Tuple[float, ...]]]:
    """tf2_msgs/TFMessage -> ``[(parent_frame, child_frame, quat xyzw), ...]``
    (translations skipped — the node consumes rotation only,
    ``set_transforms``; ``src/optic_flow.cpp:1176``)."""
    c = _Cur(buf)
    out = []
    for _ in range(c.u32()):
        # geometry_msgs/TransformStamped, field by field (the Header's
        # frame_id is the PARENT frame here, so c.header() — which discards
        # it — cannot be used)
        c.u32()  # header.seq
        c.u32(), c.u32()  # header.stamp
        parent = c.string()
        child = c.string()
        c.f64s(3)  # translation
        out.append((parent, child, c.f64s(4)))
    return out


class TfTree:
    """Rotation-only transform graph — the sliver of a tf2 buffer the node
    needs: accumulate ``(parent, child, quat)`` edges, compose the rotation
    along the frame chain (``lookup(target, source)`` = the quaternion
    rotating source-frame vectors into the target frame, like tf2's
    ``lookupTransform(target, source).rotation``)."""

    def __init__(self):
        import numpy as np  # noqa: PLC0415

        self._np = np
        #: frame -> [(neighbor, quat child->parent as stored, is_parent_edge)]
        self._edges: Dict[str, list] = {}

    def add(self, parent: str, child: str, quat) -> None:
        q = self._np.asarray(quat, float)
        self._edges.setdefault(parent, []).append((child, q, True))
        self._edges.setdefault(child, []).append((parent, q, False))

    def lookup(self, target: str, source: str):
        """Quaternion (xyzw) rotating source-frame vectors into the target
        frame, or None while either frame is unconnected."""
        from mrs_optic_flow_tpu_torch.utils.quat_np import (  # noqa: PLC0415
            np_quat_inverse,
            np_quat_multiply,
        )

        np = self._np
        if source == target:
            return np.array([0.0, 0.0, 0.0, 1.0])
        if source not in self._edges or target not in self._edges:
            return None
        # BFS from source; q_acc maps source-frame vectors into the
        # visited frame.  Edge (parent, child, q): v_parent = R(q) v_child.
        seen = {source}
        frontier = [(source, np.array([0.0, 0.0, 0.0, 1.0]))]
        while frontier:
            frame, q_acc = frontier.pop(0)
            for neighbor, q, toward_child in self._edges[frame]:
                if neighbor in seen:
                    continue
                q_step = np_quat_inverse(q) if toward_child else q
                q_next = np_quat_multiply(q_step, q_acc)
                if neighbor == target:
                    return q_next
                seen.add(neighbor)
                frontier.append((neighbor, q_next))
        return None


#: role -> (ROS type names, node callback name, decoder)
_ROLES: Dict[str, Tuple[Tuple[str, ...], str, Callable[[bytes], Any]]] = {
    "image": (("sensor_msgs/Image",), "on_image", decode_image_msg),
    "compressed_image": (
        ("sensor_msgs/CompressedImage",), "on_image", decode_compressed_image_msg,
    ),
    "camera_info": (
        ("sensor_msgs/CameraInfo",), "on_camera_info", decode_camera_info_msg,
    ),
    "imu": (("sensor_msgs/Imu",), "on_imu", decode_imu_msg),
    "odometry": (("nav_msgs/Odometry",), "on_odometry", decode_odometry_msg),
    "height": (
        ("mrs_msgs/Float64Stamped",), "on_height", decode_float64_stamped_msg,
    ),
}


def resolve_topics(
    reader,
    topics: Optional[Dict[str, str]] = None,
    roles: Optional[Dict[str, Tuple[Tuple[str, ...], str, Callable]]] = None,
) -> Dict[str, Tuple[str, Callable[[bytes], Any]]]:
    """``topic -> (callback name, decoder)`` for one bag.

    ``topics`` optionally pins ``role -> topic name`` (roles: ``image``,
    ``compressed_image``, ``camera_info``, ``imu``, ``odometry``,
    ``height``).  Unpinned roles auto-resolve when exactly ONE topic of the
    matching type exists; an ambiguous role raises with the candidates so
    the caller can pin it.  ``image``/``compressed_image`` are one camera
    family: when a bag carries both (the stock image_transport recording
    layout), the raw stream wins unless the compressed one is explicitly
    pinned — dispatching both would double every physical frame.

    ``reader`` is any object with ``topics_by_type()``; ``roles`` swaps the
    role table (``runtime/rosbag2.py`` passes the ROS2 type names).
    """
    topics = dict(topics or {})
    if roles is None:
        roles = _ROLES
    by_type = reader.topics_by_type()
    all_topics = {t for ts in by_type.values() for t in ts}
    out: Dict[str, Tuple[str, Callable[[bytes], Any]]] = {}
    auto: Dict[str, str] = {}
    pinned_roles = set(topics)
    for role, (type_names, cb, decoder) in roles.items():
        if role in topics:
            topic = topics.pop(role)
            if topic not in all_topics:
                raise BagFormatError(
                    f"pinned {role} topic {topic!r} is not in the bag "
                    f"(topics: {sorted(all_topics)})"
                )
            out[topic] = (cb, decoder)
            continue
        candidates = [t for tn in type_names for t in by_type.get(tn, [])]
        if len(candidates) > 1:
            raise BagFormatError(
                f"bag has several {type_names[0]} topics {candidates}; pin "
                f"one with topics={{{role!r}: <topic>}}"
            )
        if candidates:
            out[candidates[0]] = (cb, decoder)
            auto[role] = candidates[0]
    if topics:
        raise BagFormatError(f"unknown replay roles {sorted(topics)}")
    # one camera per replay: among auto-resolved streams raw beats
    # compressed; an explicit compressed pin beats an auto raw stream
    if "compressed_image" in auto and (
        "image" in auto or "image" in pinned_roles
    ):
        out.pop(auto["compressed_image"])
    elif "compressed_image" in pinned_roles and "image" in auto:
        out.pop(auto["image"])
    return out


def replay_bag(
    node,
    path: str,
    topics: Optional[Dict[str, str]] = None,
    *,
    default_height: float = 2.0,
    limit: Optional[int] = None,
    camera_frame: Optional[str] = None,
    uav_frame: Optional[str] = None,
) -> int:
    """Drive ``node`` with a recorded flight: dispatch the bag's messages
    to the node callbacks in record order.  Roles the bag does not carry
    get level-flight defaults per image (identity IMU/odometry,
    ``default_height``) — the same convention as the ``.ofrec`` replay
    path.  When ``camera_frame`` and ``uav_frame`` are given, the camera→
    body rotation is resolved from the bag's ``/tf``/``/tf_static``
    messages (frame-chain composition via :class:`TfTree`), reproducing
    the reference's ``timerTf`` lookup offline
    (``src/optic_flow.cpp:1165-1243``).  Returns the number of image
    frames dispatched."""
    with BagReader(path) as reader:
        return _replay_from(reader, node, topics, default_height, limit,
                            camera_frame, uav_frame)


# ------------------------------------------------------------------ #
# minimal rosbag 2.0 writer                                            #
# ------------------------------------------------------------------ #


def _encode_header(fields: Dict[str, bytes]) -> bytes:
    out = b""
    for name, value in fields.items():
        f = name.encode("latin-1") + b"=" + value
        out += struct.pack("<I", len(f)) + f
    return out


def _encode_record(fields: Dict[str, bytes], data: bytes) -> bytes:
    h = _encode_header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


class _Enc:
    """Little-endian ROS1 message serializer (the inverse of ``_Cur``)."""

    __slots__ = ("parts",)

    def __init__(self):
        self.parts: List[bytes] = []

    def u8(self, v: int):
        self.parts.append(struct.pack("<B", v))

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", v))

    def f64(self, v: float):
        self.parts.append(struct.pack("<d", v))

    def f64s(self, vs):
        vs = list(vs)
        self.parts.append(struct.pack(f"<{len(vs)}d", *vs))

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u32(len(b))
        self.parts.append(b)

    def raw(self, b: bytes):
        self.parts.append(b)

    def header(self, stamp: float, frame_id: str = ""):
        self.u32(0)  # seq
        secs = int(stamp)
        self.u32(secs)
        self.u32(int(round((stamp - secs) * 1e9)))
        self.string(frame_id)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


def encode_image_msg(msg, frame_id: str = "camera") -> bytes:
    """:class:`ImageMsg` (uint8 gray or BGR) -> sensor_msgs/Image bytes."""
    import numpy as np  # noqa: PLC0415

    arr = np.asarray(msg.data)
    if arr.dtype != np.uint8:
        arr = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    e = _Enc()
    e.header(msg.stamp, frame_id)
    e.u32(h)
    e.u32(w)
    e.string("mono8" if ch == 1 else "bgr8")
    e.u8(0)  # is_bigendian
    e.u32(w * ch)
    data = np.ascontiguousarray(arr).tobytes()
    e.u32(len(data))
    e.raw(data)
    return e.bytes()


def encode_camera_info_msg(info, stamp: float, shape=(480, 752)) -> bytes:
    """:class:`CameraInfo` -> sensor_msgs/CameraInfo bytes."""
    e = _Enc()
    e.header(stamp, "camera")
    e.u32(shape[0])
    e.u32(shape[1])
    e.string("plumb_bob")
    d = list(info.d)
    e.u32(len(d))
    e.f64s(d)
    e.f64s(list(info.k))
    e.f64s([1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0])  # R
    k = list(info.k)
    e.f64s([k[0], k[1], k[2], 0.0, k[3], k[4], k[5], 0.0, k[6], k[7], k[8], 0.0])
    e.u32(int(info.binning_x))
    e.u32(0)  # binning_y
    e.u32(0), e.u32(0), e.u32(0), e.u32(0)  # roi
    e.u8(0)  # roi.do_rectify
    return e.bytes()


def encode_imu_msg(msg) -> bytes:
    """:class:`Imu` -> sensor_msgs/Imu bytes."""
    e = _Enc()
    e.header(msg.stamp, "fcu")
    e.f64s(msg.orientation)
    e.f64s([0.0] * 9)
    e.f64s(msg.angular_velocity)
    e.f64s([0.0] * 9)
    e.f64s([0.0] * 3)  # linear acceleration
    e.f64s([0.0] * 9)
    return e.bytes()


def encode_odometry_msg(msg) -> bytes:
    """:class:`Odometry` -> nav_msgs/Odometry bytes."""
    e = _Enc()
    e.header(msg.stamp, "odom")
    e.string("fcu")  # child_frame_id
    e.f64s([0.0] * 3)  # position (not consumed by the node)
    e.f64s(msg.orientation)
    e.f64s([0.0] * 36)
    e.f64s(msg.linear_velocity)
    e.f64s(msg.angular_velocity)
    e.f64s([0.0] * 36)
    return e.bytes()


def encode_float64_stamped_msg(msg) -> bytes:
    """:class:`Float64Stamped` -> mrs_msgs/Float64Stamped bytes."""
    e = _Enc()
    e.header(msg.stamp, "")
    e.f64(float(msg.value))
    return e.bytes()


class BagWriter:
    """Tiny rosbag 2.0 writer: unchunked top-level connection + message
    records — the minimal well-formed layout this module's
    :class:`BagReader` streams directly (``rosbag reindex`` upgrades it for
    stock ROS tools; md5sums are written as ``*`` since the node-side types
    are duck-typed).  Exists so synthetic flights
    (:class:`~mrs_optic_flow_tpu_torch.runtime.flightsim.FlightSimulator`) can be
    archived and replayed through the SAME offline path real flight bags
    use (``replay_bag``)."""

    def __init__(self, path: str):
        self._fh = open(path, "wb")  # noqa: SIM115
        self._fh.write(_MAGIC)
        # bag header record: conn/chunk counts are for indexed readers;
        # this stream is index-free (index_pos=0 means "unindexed")
        hdr = _encode_record(
            {"op": b"\x03", "index_pos": struct.pack("<Q", 0),
             "conn_count": struct.pack("<I", 0),
             "chunk_count": struct.pack("<I", 0)},
            b" " * 4096,  # rosbag pads the header record to 4 KB
        )
        self._fh.write(hdr)
        self._conns: Dict[str, int] = {}

    def _connection(self, topic: str, type_name: str) -> int:
        if topic in self._conns:
            return self._conns[topic]
        conn = len(self._conns)
        self._conns[topic] = conn
        conn_hdr = _encode_header({
            "topic": topic.encode(), "type": type_name.encode(),
            "md5sum": b"*", "message_definition": b"",
        })
        self._fh.write(_encode_record(
            {"op": b"\x07", "conn": struct.pack("<I", conn),
             "topic": topic.encode()},
            conn_hdr,
        ))
        return conn

    def write(self, topic: str, type_name: str, stamp: float, raw: bytes):
        conn = self._connection(topic, type_name)
        secs = int(stamp)
        nsecs = int(round((stamp - secs) * 1e9))
        self._fh.write(_encode_record(
            {"op": b"\x02", "conn": struct.pack("<I", conn),
             "time": struct.pack("<II", secs, nsecs)},
            raw,
        ))

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "BagWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _replay_from(reader, node, topics, default_height, limit,
                 camera_frame=None, uav_frame=None, *,
                 roles=None, tf_types=("tf2_msgs/TFMessage",),
                 tf_decode=decode_tf_message) -> int:
    from mrs_optic_flow_tpu_torch.runtime.msgs import (  # noqa: PLC0415
        CameraInfo,
        Imu,
        Odometry,
    )

    routing = resolve_topics(reader, topics, roles)
    have_cbs = {cb for cb, _ in routing.values()}
    tf_tree = TfTree() if (camera_frame and uav_frame) else None
    frames = 0
    for t, topic, type_name, raw in reader.messages():
        if tf_tree is not None and type_name in tf_types:
            for parent, child, quat in tf_decode(raw):
                tf_tree.add(parent, child, quat)
            if not node.got_tfs:
                c2b = tf_tree.lookup(uav_frame, camera_frame)
                if c2b is not None:
                    # set_transforms' default cam_yaw IS the timerTf
                    # convention: yaw(inverse(c2b)) + pi/2
                    # (src/optic_flow.cpp:1203-1208)
                    node.set_transforms(c2b)
            continue
        route = routing.get(topic)
        if route is None:
            continue
        cb, decoder = route
        msg = decoder(raw)
        if cb == "on_image":
            # synthesize the missing readiness inputs the way --replay
            # file.ofrec does, so image-only bags still produce twists
            if "on_camera_info" not in have_cbs and not node.got_camera_info:
                h, w = msg.data.shape[:2]
                node.on_camera_info(CameraInfo(
                    k=[420.0, 0, w / 2, 0, 420.0, h / 2, 0, 0, 1],
                    d=[0.0] * 5,
                ))
            if "on_imu" not in have_cbs:
                node.on_imu(Imu(stamp=t, angular_velocity=(0.0, 0.0, 0.0),
                                orientation=(0.0, 0.0, 0.0, 1.0)))
            if "on_odometry" not in have_cbs:
                node.on_odometry(Odometry(stamp=t, orientation=(0.0, 0.0, 0.0, 1.0)))
            if "on_height" not in have_cbs:
                node.on_height(Float64Stamped(stamp=t, value=default_height))
            frames += 1
        getattr(node, cb)(msg)
        if limit is not None and frames >= limit:
            break
    return frames
