"""Offline ROS2 rosbag2 replay — no ROS installation required.

The port's own copy of :mod:`mrs_optic_flow_tpu.runtime.rosbag2` (stdlib and
numpy; the port imports nothing of the JAX package): the same storages,
CDR decoders and encoders, writer and replay, driving the port's node
through :func:`.rosbag._replay_from`.  Unlike the JAX package it reads
``metadata.yaml``'s ``relative_file_paths`` without a YAML library (the
card has none), so a split bag replays in its metadata order there too.

The reference targets ROS1 (``package.xml``, noetic/melodic CI), but the
flights its users record today increasingly live in **rosbag2** archives:
a bag directory (``metadata.yaml`` + storage files) where each message is
serialized as DDS **CDR** instead of ROS1's flat little-endian format.
This module is the rosbag2 counterpart of :mod:`.rosbag` and closes that
half of the replay surface with the stdlib:

- :class:`Bag2Reader` reads BOTH rosbag2 storage plugins — the sqlite3
  ``*.db3`` schema (storage versions 2-6; ``sqlite3`` ships with CPython)
  and **MCAP** ``*.mcap`` files (the default storage since ROS2 Jazzy:
  record stream, schema/channel/message records, chunked or unchunked;
  ``none`` chunk compression natively, ``lz4``/``zstd`` when the optional
  modules exist — the same gating as the ROS1 reader's lz4 chunks) — from
  a single storage file or a bag directory (split files replay in
  ``metadata.yaml`` order when parseable, filename order otherwise;
  content is sniffed by magic, not extension).
- :class:`_Cdr` is a plain-CDR (XCDR1) cursor — encapsulation header,
  both endiannesses, size-aligned primitives, u32-length-with-NUL
  strings — covering exactly the message set the node consumes.  ROS2
  message layouts differ from ROS1 (no ``Header.seq``, ``Time.sec`` is
  int32, CameraInfo's fields are lowercase ``d``/``k``/...), so each
  type gets its own decoder here; the duck-typed objects then reuse the
  conformance-tested converters in :mod:`.ros_bridge`.
- :func:`replay_bag2` drives the SAME replay loop as the ROS1 path
  (:func:`.rosbag._replay_from` — role auto-resolution, level-flight
  defaults, ``/tf``/``/tf_static`` camera→body resolution) with the ROS2
  role table.

The CLI accepts it directly: ``python -m mrs_optic_flow_tpu_torch --replay
flight_dir/`` (or ``--replay flight.db3`` / ``flight.mcap``);
``--bag-info`` understands every format.

Writing: :class:`Bag2Writer` produces the standard bag-directory layout
(one sqlite3 storage file + ``metadata.yaml``) with plain-CDR messages
(:class:`_CdrEnc` + the ``encode_*_msg`` twins of the decoders above) —
the ROS2 counterpart of :class:`.rosbag.BagWriter`, used by
``FlightSimulator.record_bag2`` so synthetic flights archive through the
same artifact format real ROS2 recordings replay from.
"""

from __future__ import annotations

import os
import re
import sqlite3
import struct
from types import SimpleNamespace
from typing import Any, Dict, Iterator, List, Optional, Tuple

from mrs_optic_flow_tpu_torch.runtime import ros_bridge as _rb
from mrs_optic_flow_tpu_torch.runtime.msgs import Float64Stamped
from mrs_optic_flow_tpu_torch.runtime.rosbag import (
    BagFormatError,
    _replay_from,
)


class Bag2FormatError(BagFormatError):
    """The file/directory is not a parseable rosbag2 (sqlite3) bag."""


_STORAGE_EXTS = (".db3", ".mcap")


def is_rosbag2(path: str) -> bool:
    """Cheap dispatch test used by the CLI: a ``.db3``/``.mcap`` file, or a
    directory holding ``metadata.yaml`` / storage files."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "metadata.yaml")):
            return True
        try:
            return any(n.endswith(_STORAGE_EXTS) for n in os.listdir(path))
        except OSError:
            return False
    return path.endswith(_STORAGE_EXTS)


# ------------------------------------------------------------------ #
# storage backends (sqlite3 .db3 + MCAP)                               #
# ------------------------------------------------------------------ #


def _natural_key(name: str):
    """Numeric-aware sort key: rosbag2 names split files ``<bag>_<N>.db3``,
    and a lexicographic sort would order _10 before _2 — replaying a long
    bag's parts out of chronological order when metadata.yaml is absent."""
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", name)]


def _unquote(text: str) -> str:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    return text


def _strip_comment(line: str) -> str:
    """``line`` without its ``#`` comment: a ``#`` at the start or after
    whitespace, outside a quoted scalar (a quoted ``'a #1.db3'`` is a name,
    as ``yaml.safe_load`` reads it; a quote opens a scalar only at its
    start, so the ``'`` of a plain ``it's.db3`` does not)."""
    quote = None
    for i, ch in enumerate(line):
        if quote is None:
            if ch in "'\"" and (i == 0 or line[i - 1] in " \t[,"):
                quote = ch
            elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
                return line[:i].rstrip()
        elif ch == quote and not (quote == '"' and line[i - 1] == "\\"):
            quote = None
    return line.rstrip()


def _split_flow(body: str) -> List[str]:
    """The items of a flow list's body (between ``[`` and ``]``): split at
    the commas outside quotes, each unquoted."""
    items, quote, start = [], None, 0
    for i, ch in enumerate(body):
        if quote is None and ch in "'\"" and (i == 0 or body[i - 1] in " \t[,"):
            quote = ch
        elif ch == quote:
            quote = None
        elif quote is None and ch == ",":
            items.append(body[start:i])
            start = i + 1
    items.append(body[start:])
    return [_unquote(v) for v in items if v.strip()]


def _relative_file_paths(text: str) -> List[str]:
    """``rosbag2_bagfile_information.relative_file_paths`` of a
    ``metadata.yaml``, read without a YAML library: a block list (items at
    the key's indentation or deeper) or a flow list of plain or quoted
    names, on one line or split over several up to its ``]``.  ``[]`` when
    the text has no such list."""
    in_info, key_indent, paths, flow = False, None, [], None
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if flow is not None:
            flow += " " + line.strip()
            if flow.endswith("]"):
                return _split_flow(flow[1:-1])
            continue
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        item = line.strip()
        if key_indent is not None:
            if item.startswith("-") and item[1:2] in ("", " ") and indent >= key_indent:
                paths.append(_unquote(item[1:]))
                continue
            break  # the list ended
        if indent == 0:
            in_info = item == "rosbag2_bagfile_information:"
            continue
        key, sep, value = item.partition(":")
        if in_info and sep and key == "relative_file_paths":
            value = value.strip()
            if value.startswith("[") and value.endswith("]"):
                return _split_flow(value[1:-1])
            if value.startswith("["):
                flow = value  # a flow list continued on the next lines
                continue
            if value:
                return []
            key_indent = indent
    return [p for p in paths if p]


def _storage_files(path: str) -> List[str]:
    """The bag's storage files in replay order."""
    if not os.path.isdir(path):
        return [path]
    names = sorted((n for n in os.listdir(path) if n.endswith(_STORAGE_EXTS)),
                   key=_natural_key)
    meta = os.path.join(path, "metadata.yaml")
    if os.path.exists(meta):
        # honor metadata.yaml's relative_file_paths order when possible
        # (split bags are chronological in that order); fall back to the
        # name sort on any trouble — never fail the replay over it
        try:
            with open(meta) as fh:
                rel = _relative_file_paths(fh.read())
            ordered = [
                os.path.join(path, r) for r in rel
                if os.path.exists(os.path.join(path, r))
            ]
            if ordered:
                extra = [os.path.join(path, n) for n in names
                         if os.path.join(path, n) not in ordered]
                return ordered + extra
        except Exception:  # noqa: BLE001 — metadata is advisory only
            pass
    if not names:
        raise Bag2FormatError(
            f"{path}: no .db3/.mcap storage files in directory"
        )
    return [os.path.join(path, n) for n in names]


class _SqliteStorage:
    """One rosbag2 sqlite3 (``.db3``) storage file."""

    def __init__(self, fname: str):
        self.fname = fname

    def close(self) -> None:  # connections are per-call; nothing held
        pass

    @staticmethod
    def _connect(fname: str) -> sqlite3.Connection:
        if not os.path.exists(fname):
            raise Bag2FormatError(f"{fname}: no such file")
        # uri=True + mode=ro: never create/modify a database at this path
        try:
            con = sqlite3.connect(
                f"file:{fname}?mode=ro&immutable=1", uri=True
            )
        except sqlite3.OperationalError:
            # sqlite URI parsing chokes on some path characters (space, %,
            # #); plain connect still only ever SELECTs here
            con = sqlite3.connect(fname)
        con.text_factory = lambda b: b.decode("utf-8", "replace")
        return con

    def topics(self) -> List[Tuple[str, str, Optional[str]]]:
        """``[(topic, type name, serialization format), ...]``."""
        con = self._connect(self.fname)
        try:
            try:
                rows = con.execute(
                    "SELECT name, type, serialization_format FROM topics"
                ).fetchall()
                return [(n, t, f) for n, t, f in rows]
            except sqlite3.OperationalError:
                # storage v1 lacks serialization_format
                rows = con.execute("SELECT name, type FROM topics").fetchall()
                return [(n, t, None) for n, t in rows]
        except sqlite3.DatabaseError as e:
            raise Bag2FormatError(
                f"{self.fname}: not a rosbag2 sqlite3 storage file ({e})"
            ) from e
        finally:
            con.close()

    def messages(self, topic_types: Dict[str, str]
                 ) -> Iterator[Tuple[float, str, str, bytes]]:
        fname = self.fname
        con = self._connect(fname)
        try:
            try:
                topic_of = dict(
                    con.execute("SELECT id, name FROM topics").fetchall()
                )
                cur = con.execute(
                    "SELECT timestamp, topic_id, data FROM messages "
                    "ORDER BY timestamp, id"
                )
                rows = iter(cur.fetchmany(256))
            except sqlite3.DatabaseError as e:
                raise Bag2FormatError(
                    f"{fname}: not a rosbag2 sqlite3 storage file ({e})"
                ) from e
            while True:
                for ts, topic_id, data in rows:
                    topic = topic_of.get(topic_id)
                    if topic is None:
                        raise Bag2FormatError(
                            f"{fname}: message references unknown "
                            f"topic id {topic_id}"
                        )
                    yield (
                        ts * 1e-9, topic,
                        topic_types.get(topic, ""), bytes(data),
                    )
                try:
                    # batched fetch: a DatabaseError surfacing mid-iteration
                    # (truncated storage) must still wrap as Bag2FormatError
                    batch = cur.fetchmany(256)
                except sqlite3.DatabaseError as e:
                    raise Bag2FormatError(
                        f"{fname}: corrupt rosbag2 storage ({e})"
                    ) from e
                if not batch:
                    break
                rows = iter(batch)
        finally:
            con.close()


# --- MCAP storage (the rosbag2 default since ROS2 Jazzy) ------------ #

_MCAP_MAGIC = b"\x89MCAP0\r\n"
_SQLITE_MAGIC = b"SQLite format 3\x00"

# MCAP record opcodes (mcap.dev spec)
_MCAP_FOOTER = 0x02
_MCAP_SCHEMA = 0x03
_MCAP_CHANNEL = 0x04
_MCAP_MESSAGE = 0x05
_MCAP_CHUNK = 0x06
_MCAP_DATA_END = 0x0F


def _mcap_decompress(compression: str, data: bytes, size: int,
                     fname: str) -> bytes:
    if compression in ("", "none"):
        return bytes(data)
    if compression == "lz4":
        try:
            import lz4.frame  # noqa: PLC0415 — optional
        except ImportError as e:
            raise Bag2FormatError(
                f"{fname}: MCAP chunk uses lz4 compression and the lz4 "
                "module is not available"
            ) from e
        return lz4.frame.decompress(bytes(data))
    if compression == "zstd":
        try:
            try:
                from compression import zstd  # noqa: PLC0415 — py3.14+

                return zstd.decompress(bytes(data))
            except ImportError:
                import zstandard  # noqa: PLC0415 — optional

                return zstandard.ZstdDecompressor().decompress(
                    bytes(data), max_output_size=size or -1
                )
        except ImportError as e:
            raise Bag2FormatError(
                f"{fname}: MCAP chunk uses zstd compression and neither "
                "compression.zstd (py>=3.14) nor the zstandard module is "
                "available"
            ) from e
    raise Bag2FormatError(
        f"{fname}: unknown MCAP chunk compression {compression!r}"
    )


class _McapStorage:
    """One MCAP storage file: schema/channel discovery + message stream.

    The reader is index-free (like the ROS1 reader): it walks the record
    stream in order — the spec guarantees a channel's Schema and Channel
    records precede its first Message in stream order — and descends into
    Chunk records.  Summary-section repeats of schema/channel records are
    harmlessly idempotent; Footer stops the scan.
    """

    def __init__(self, fname: str):
        self.fname = fname
        # mmap, not read(): flight bags are GBs and the walk touches each
        # record once per pass — same policy as the ROS1 BagReader
        self._fh = open(fname, "rb")  # noqa: SIM115 — backs the mmap
        try:
            import mmap  # noqa: PLC0415

            try:
                mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
                self._buf: Any = memoryview(mm)
            except (ValueError, OSError):  # empty/exotic fs: plain bytes
                self._fh.seek(0)
                self._buf = self._fh.read()
            if bytes(self._buf[: len(_MCAP_MAGIC)]) != _MCAP_MAGIC:
                raise Bag2FormatError(
                    f"{fname}: not an MCAP file (bad magic)"
                )
        except BaseException:
            self.close()
            raise
        #: channel id -> (topic, type name, message encoding)
        self._channels: Dict[int, Tuple[str, str, str]] = {}
        self._schemas: Dict[int, str] = {}

    def close(self) -> None:
        buf, self._buf = getattr(self, "_buf", b""), b""
        if isinstance(buf, memoryview):
            mm = buf.obj
            buf.release()
            try:
                mm.close()
            except BufferError:
                pass  # stray slices die with their frames; never mask errors
        self._fh.close()

    @staticmethod
    def _records(buf, off, end, fname):
        """Yield ``(opcode, payload)`` records from ``buf[off:end]``."""
        while off + 9 <= end:
            op = buf[off]
            (ln,) = struct.unpack_from("<Q", buf, off + 1)
            off += 9
            if off + ln > end:
                raise Bag2FormatError(f"{fname}: truncated MCAP record")
            yield op, buf[off : off + ln]
            off += ln

    @staticmethod
    def _string(buf, off) -> Tuple[str, int]:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        s = bytes(buf[off : off + n])
        if len(s) != n:
            raise Bag2FormatError("truncated MCAP string")
        return s.decode("utf-8", "replace"), off + n

    def _note(self, op: int, payload: bytes) -> None:
        if op == _MCAP_SCHEMA:
            (sid,) = struct.unpack_from("<H", payload, 0)
            name, _ = self._string(payload, 2)
            self._schemas[sid] = name
        elif op == _MCAP_CHANNEL:
            sid, = struct.unpack_from("<H", payload, 2)
            (cid,) = struct.unpack_from("<H", payload, 0)
            topic, off = self._string(payload, 4)
            encoding, _ = self._string(payload, off)
            self._channels[cid] = (
                topic, self._schemas.get(sid, ""), encoding
            )

    def _walk(self) -> Iterator[Tuple[int, Any]]:
        """All records, descending into chunks, noting schemas/channels."""
        try:
            for op, payload in self._records(
                self._buf, len(_MCAP_MAGIC), len(self._buf), self.fname
            ):
                if op in (_MCAP_FOOTER, _MCAP_DATA_END):
                    # the summary section only repeats what the data
                    # section already declared; stop at data end
                    if op == _MCAP_FOOTER:
                        return
                    continue
                if op == _MCAP_CHUNK:
                    # u64 start/end times, u64 uncompressed_size, u32 crc,
                    # string compression, u64 records length, records
                    (size,) = struct.unpack_from("<Q", payload, 16)
                    compression, off = self._string(payload, 28)
                    (rlen,) = struct.unpack_from("<Q", payload, off)
                    inner = _mcap_decompress(
                        compression, payload[off + 8 : off + 8 + rlen],
                        size, self.fname,
                    )
                    for iop, ipayload in self._records(
                        inner, 0, len(inner), self.fname
                    ):
                        self._note(iop, ipayload)
                        yield iop, ipayload
                    continue
                self._note(op, payload)
                yield op, payload
        except struct.error as e:
            raise Bag2FormatError(
                f"{self.fname}: truncated MCAP record ({e})"
            ) from e

    def _topics_from_summary(self) -> bool:
        """Channel discovery via the footer's ``summary_start`` (the spec's
        mechanism: the summary section repeats every Schema/Channel record
        uncompressed).  Returns False when there is no summary."""
        buf, n = self._buf, len(self._buf)
        # footer record (op 0x02, u64 len=20, 20-byte payload) + end magic
        tail = 1 + 8 + 20 + len(_MCAP_MAGIC)
        if n < tail or bytes(buf[n - 8 :]) != _MCAP_MAGIC:
            return False
        if buf[n - tail] != _MCAP_FOOTER:
            return False
        (flen,) = struct.unpack_from("<Q", buf, n - tail + 1)
        if flen != 20:
            return False
        (summary_start,) = struct.unpack_from("<Q", buf, n - tail + 9)
        if not summary_start or summary_start >= n - tail:
            return False
        for op, payload in self._records(
            buf, summary_start, n - tail, self.fname
        ):
            self._note(op, payload)
        return bool(self._channels)

    def topics(self) -> List[Tuple[str, str, Optional[str]]]:
        # cheap paths first — no chunk decompression: (a) the summary
        # section when the footer points at one; (b) a top-level scan when
        # the bag has no chunks at all.  A chunked bag without a summary
        # needs the full walk (chunks can hide Channel records).
        try:
            if not self._topics_from_summary():
                saw_chunk = False
                for op, payload in self._records(
                    self._buf, len(_MCAP_MAGIC), len(self._buf), self.fname
                ):
                    if op == _MCAP_FOOTER:
                        break
                    if op == _MCAP_CHUNK:
                        saw_chunk = True
                        continue
                    self._note(op, payload)
                if saw_chunk:
                    for _ in self._walk():  # re-notes idempotently
                        pass
        except struct.error as e:
            raise Bag2FormatError(
                f"{self.fname}: truncated MCAP record ({e})"
            ) from e
        return [(topic, type_name, enc)
                for topic, type_name, enc in self._channels.values()]

    def messages(self, topic_types: Dict[str, str]
                 ) -> Iterator[Tuple[float, str, str, bytes]]:
        for op, payload in self._walk():
            if op != _MCAP_MESSAGE:
                continue
            (cid,) = struct.unpack_from("<H", payload, 0)
            (log_time,) = struct.unpack_from("<Q", payload, 6)
            chan = self._channels.get(cid)
            if chan is None:
                raise Bag2FormatError(
                    f"{self.fname}: message references unknown channel {cid}"
                )
            topic, type_name, _enc = chan
            yield log_time * 1e-9, topic, type_name, bytes(payload[22:])


def _open_storage(fname: str):
    """Sniff the storage flavor by content magic (extension as fallback
    for short/empty files)."""
    if not os.path.exists(fname):
        raise Bag2FormatError(f"{fname}: no such file")
    with open(fname, "rb") as fh:
        head = fh.read(16)
    if head.startswith(_MCAP_MAGIC):
        return _McapStorage(fname)
    if head.startswith(_SQLITE_MAGIC) or not fname.endswith(".mcap"):
        return _SqliteStorage(fname)
    return _McapStorage(fname)  # .mcap extension, bad magic: its error


class Bag2Reader:
    """Stream ``(time_s, topic, type_name, raw_cdr_bytes)`` from a rosbag2
    bag — a ``.db3``/``.mcap`` storage file or a bag directory."""

    def __init__(self, path: str):
        self.path = path
        self.files = _storage_files(path)
        self._storages: List[Any] = []
        #: topic name -> ROS2 type name (e.g. ``sensor_msgs/msg/Image``)
        self.topic_types: Dict[str, str] = {}
        try:
            for f in self.files:
                self._storages.append(_open_storage(f))
            for st in self._storages:
                for name, type_name, fmt in st.topics():
                    if fmt not in ("cdr", "", None):
                        raise Bag2FormatError(
                            f"{st.fname}: topic {name!r} uses serialization "
                            f"{fmt!r}; only 'cdr' is supported"
                        )
                    self.topic_types[name] = type_name
        except BaseException:
            self.close()
            raise

    def messages(self) -> Iterator[Tuple[float, str, str, bytes]]:
        for st in self._storages:
            yield from st.messages(self.topic_types)

    def topics_by_type(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for topic, type_name in self.topic_types.items():
            out.setdefault(type_name, [])
            if topic not in out[type_name]:
                out[type_name].append(topic)
        return out

    def close(self) -> None:
        for st in self._storages:
            st.close()
        self._storages = []

    def __enter__(self) -> "Bag2Reader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------ #
# CDR (XCDR1) deserialization                                          #
# ------------------------------------------------------------------ #


class _Cdr:
    """Plain-CDR cursor: 4-byte encapsulation header (``00 01`` = LE,
    ``00 00`` = BE), then size-aligned primitives relative to byte 4.
    XCDR2/PL_CDR representations (mutable/appendable types — not used by
    the stock ROS2 message set) are rejected up front."""

    __slots__ = ("buf", "off", "e")

    def __init__(self, buf: bytes):
        if len(buf) < 4 or buf[0] != 0x00 or buf[1] > 0x01:
            rep = buf[:2].hex() if len(buf) >= 2 else buf.hex()
            raise Bag2FormatError(
                f"unsupported CDR encapsulation {rep!r} (plain CDR "
                "expected; PL_CDR/XCDR2 payloads are not ROS2 stock types)"
            )
        self.buf = buf
        self.off = 4
        self.e = "<" if buf[1] == 0x01 else ">"

    def _align(self, n: int) -> None:
        self.off += (-(self.off - 4)) % n

    def _unpack(self, fmt: str, size: int):
        self._align(size)
        try:
            (v,) = struct.unpack_from(self.e + fmt, self.buf, self.off)
        except struct.error as e:
            raise Bag2FormatError(f"truncated CDR payload ({e})") from e
        self.off += size
        return v

    def u8(self) -> int:
        return self._unpack("B", 1)

    def u32(self) -> int:
        return self._unpack("I", 4)

    def i32(self) -> int:
        return self._unpack("i", 4)

    def f64(self) -> float:
        return self._unpack("d", 8)

    def f64s(self, n: int) -> Tuple[float, ...]:
        self._align(8)
        try:
            v = struct.unpack_from(f"{self.e}{n}d", self.buf, self.off)
        except struct.error as e:
            raise Bag2FormatError(f"truncated CDR payload ({e})") from e
        self.off += 8 * n
        return v

    def seq_f64(self) -> Tuple[float, ...]:
        return self.f64s(self.u32())

    def string(self) -> str:
        n = self.u32()  # length INCLUDING the NUL terminator
        v = self.buf[self.off : self.off + n]
        if len(v) != n:
            raise Bag2FormatError("truncated CDR string")
        self.off += n
        return v[:-1].decode("utf-8", "replace") if n else ""

    def raw(self, n: int) -> bytes:
        v = self.buf[self.off : self.off + n]
        if len(v) != n:
            raise Bag2FormatError("truncated CDR byte sequence")
        self.off += n
        return v

    def bytes_seq(self) -> bytes:
        return self.raw(self.u32())

    def time(self) -> float:
        """builtin_interfaces/Time: int32 sec + uint32 nanosec."""
        return self.i32() + self.u32() * 1e-9

    def header(self) -> float:
        """std_msgs/Header (ROS2: stamp + frame_id, NO seq) -> stamp [s]."""
        stamp = self.time()
        self.string()  # frame_id
        return stamp

    def xyz(self) -> SimpleNamespace:
        return SimpleNamespace(x=self.f64(), y=self.f64(), z=self.f64())

    def quat(self) -> SimpleNamespace:
        return SimpleNamespace(
            x=self.f64(), y=self.f64(), z=self.f64(), w=self.f64()
        )


def _hdr_ns(stamp: float) -> SimpleNamespace:
    return SimpleNamespace(stamp=stamp)


def decode_image_msg(buf: bytes):
    """sensor_msgs/msg/Image -> :class:`ImageMsg` (via the bridge's stride-
    and encoding-aware ``decode_image``)."""
    c = _Cdr(buf)
    stamp = c.header()
    height, width = c.u32(), c.u32()
    encoding = c.string()
    c.u8()  # is_bigendian — pixel data is bytes; CDR's endianness is c.e
    step = c.u32()
    data = c.bytes_seq()
    return _rb.decode_image(
        SimpleNamespace(
            header=_hdr_ns(stamp), height=height, width=width,
            encoding=encoding, step=step, data=data,
        )
    )


def decode_compressed_image_msg(buf: bytes):
    """sensor_msgs/msg/CompressedImage -> :class:`ImageMsg` (cv2 decode,
    like the ROS1 path)."""
    c = _Cdr(buf)
    stamp = c.header()
    fmt = c.string()
    data = c.bytes_seq()
    try:
        import cv2  # noqa: PLC0415 — optional
        import numpy as np  # noqa: PLC0415
    except ImportError as e:
        raise Bag2FormatError(
            f"CompressedImage ({fmt!r}) in the bag needs cv2 to decode"
        ) from e
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise Bag2FormatError(f"cv2 could not decode CompressedImage ({fmt!r})")
    from mrs_optic_flow_tpu_torch.runtime.msgs import ImageMsg  # noqa: PLC0415

    return ImageMsg(stamp=stamp, data=img[..., :3] if img.ndim == 3 else img)


def decode_camera_info_msg(buf: bytes):
    """sensor_msgs/msg/CameraInfo -> :class:`CameraInfo` (ROS2 field names
    are lowercase ``d``/``k``/``r``/``p``; same wire order as ROS1)."""
    c = _Cdr(buf)
    stamp = c.header()
    c.u32(), c.u32()  # height, width
    c.string()  # distortion_model
    d = list(c.seq_f64())
    k = list(c.f64s(9))
    c.f64s(9)  # r
    c.f64s(12)  # p
    binning_x = c.u32()
    return _rb.from_camera_info(
        SimpleNamespace(header=_hdr_ns(stamp), K=k, D=d, binning_x=binning_x)
    )


def decode_imu_msg(buf: bytes):
    """sensor_msgs/msg/Imu -> :class:`Imu`."""
    c = _Cdr(buf)
    stamp = c.header()
    orientation = c.quat()
    c.f64s(9)  # orientation_covariance
    angular_velocity = c.xyz()
    # remaining covariances + linear acceleration: not consumed by the node
    return _rb.from_imu(
        SimpleNamespace(
            header=_hdr_ns(stamp),
            orientation=orientation,
            angular_velocity=angular_velocity,
        )
    )


def decode_odometry_msg(buf: bytes):
    """nav_msgs/msg/Odometry -> :class:`Odometry`."""
    c = _Cdr(buf)
    stamp = c.header()
    c.string()  # child_frame_id
    c.xyz()  # pose.pose.position
    orientation = c.quat()
    c.f64s(36)  # pose.covariance
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
    """mrs_msgs/msg/Float64Stamped (the height topic's ROS2 port)."""
    c = _Cdr(buf)
    stamp = c.header()
    return Float64Stamped(stamp=stamp, value=c.f64())


def decode_tf_message(buf: bytes) -> List[Tuple[str, str, Tuple[float, ...]]]:
    """tf2_msgs/msg/TFMessage -> ``[(parent, child, quat xyzw), ...]``
    (rotation only, like the ROS1 decoder — the node consumes no
    translations)."""
    c = _Cdr(buf)
    out = []
    for _ in range(c.u32()):
        # geometry_msgs/msg/TransformStamped: the Header's frame_id is the
        # PARENT frame, so it is read field by field
        c.time()  # header.stamp
        parent = c.string()
        child = c.string()
        c.f64s(3)  # transform.translation
        out.append((parent, child, c.f64s(4)))
    return out


#: role -> (ROS2 type names, node callback name, decoder) — the ROS2 twin
#: of ``rosbag._ROLES``; ``std_msgs/msg/Float64Stamped`` is accepted for
#: height alongside the mrs_msgs name (same wire layout, used by stacks
#: that vendor the type).
_ROLES2: Dict[str, Tuple[Tuple[str, ...], str, Any]] = {
    "image": (("sensor_msgs/msg/Image",), "on_image", decode_image_msg),
    "compressed_image": (
        ("sensor_msgs/msg/CompressedImage",), "on_image",
        decode_compressed_image_msg,
    ),
    "camera_info": (
        ("sensor_msgs/msg/CameraInfo",), "on_camera_info",
        decode_camera_info_msg,
    ),
    "imu": (("sensor_msgs/msg/Imu",), "on_imu", decode_imu_msg),
    "odometry": (("nav_msgs/msg/Odometry",), "on_odometry",
                 decode_odometry_msg),
    "height": (
        ("mrs_msgs/msg/Float64Stamped", "std_msgs/msg/Float64Stamped"),
        "on_height", decode_float64_stamped_msg,
    ),
}

_TF_TYPES2 = ("tf2_msgs/msg/TFMessage",)


def replay_bag2(
    node,
    path: str,
    topics: Optional[Dict[str, str]] = None,
    *,
    default_height: float = 2.0,
    limit: Optional[int] = None,
    camera_frame: Optional[str] = None,
    uav_frame: Optional[str] = None,
) -> int:
    """Drive ``node`` with a recorded ROS2 flight — rosbag2's counterpart
    of :func:`.rosbag.replay_bag`, same semantics (role auto-resolution and
    pinning, level-flight defaults for missing roles, camera→body from the
    bag's ``/tf``/``/tf_static`` when the frame ids are given).  Returns
    the number of image frames dispatched."""
    with Bag2Reader(path) as reader:
        return _replay_from(
            reader, node, topics, default_height, limit,
            camera_frame, uav_frame,
            roles=_ROLES2, tf_types=_TF_TYPES2, tf_decode=decode_tf_message,
        )


# ------------------------------------------------------------------ #
# minimal rosbag2 writer (sqlite3 storage)                            #
# ------------------------------------------------------------------ #


class _CdrEnc:
    """Little-endian plain-CDR (XCDR1) serializer — the inverse of
    :class:`_Cdr`: 4-byte encapsulation header (``00 01 00 00`` = LE),
    then size-aligned primitives relative to byte 4."""

    __slots__ = ("parts", "off")

    def __init__(self):
        self.parts: List[bytes] = [b"\x00\x01\x00\x00"]
        self.off = 0  # bytes written past the encapsulation header

    def _align(self, n: int) -> None:
        pad = (-self.off) % n
        if pad:
            self.parts.append(b"\x00" * pad)
            self.off += pad

    def _pack(self, fmt: str, size: int, v) -> None:
        self._align(size)
        self.parts.append(struct.pack("<" + fmt, v))
        self.off += size

    def u8(self, v: int):
        self._pack("B", 1, v)

    def u32(self, v: int):
        self._pack("I", 4, v)

    def i32(self, v: int):
        self._pack("i", 4, v)

    def f64(self, v: float):
        self._pack("d", 8, float(v))

    def f64s(self, vs):
        vs = [float(v) for v in vs]
        self._align(8)
        self.parts.append(struct.pack(f"<{len(vs)}d", *vs))
        self.off += 8 * len(vs)

    def string(self, s: str):
        b = s.encode("utf-8") + b"\x00"  # length INCLUDES the NUL
        self.u32(len(b))
        self.parts.append(b)
        self.off += len(b)

    def raw(self, b: bytes):
        self.parts.append(b)
        self.off += len(b)

    def bytes_seq(self, b: bytes):
        self.u32(len(b))
        self.raw(b)

    def time(self, stamp: float):
        """builtin_interfaces/Time: int32 sec + uint32 nanosec."""
        secs = int(stamp)
        self.i32(secs)
        self.u32(int(round((stamp - secs) * 1e9)))

    def header(self, stamp: float, frame_id: str = ""):
        """std_msgs/Header (ROS2: stamp + frame_id, NO seq)."""
        self.time(stamp)
        self.string(frame_id)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


def encode_image_msg(msg, frame_id: str = "camera") -> bytes:
    """:class:`ImageMsg` (uint8 gray or BGR) -> sensor_msgs/msg/Image CDR."""
    import numpy as np  # noqa: PLC0415

    arr = np.asarray(msg.data)
    if arr.dtype != np.uint8:
        arr = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    e = _CdrEnc()
    e.header(msg.stamp, frame_id)
    e.u32(h)
    e.u32(w)
    e.string("mono8" if ch == 1 else "bgr8")
    e.u8(0)  # is_bigendian
    e.u32(w * ch)
    e.bytes_seq(np.ascontiguousarray(arr).tobytes())
    return e.bytes()


def encode_camera_info_msg(info, stamp: float, shape=(480, 752)) -> bytes:
    """:class:`CameraInfo` -> sensor_msgs/msg/CameraInfo CDR."""
    e = _CdrEnc()
    e.header(stamp, "camera")
    e.u32(shape[0])
    e.u32(shape[1])
    e.string("plumb_bob")
    d = [float(v) for v in info.d]
    e.u32(len(d))
    e.f64s(d)
    k = [float(v) for v in info.k]
    e.f64s(k)
    e.f64s([1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0])  # r
    e.f64s([k[0], k[1], k[2], 0.0, k[3], k[4], k[5], 0.0,
            k[6], k[7], k[8], 0.0])  # p
    e.u32(int(info.binning_x))
    e.u32(0)  # binning_y
    e.u32(0), e.u32(0), e.u32(0), e.u32(0)  # roi
    e.u8(0)  # roi.do_rectify
    return e.bytes()


def encode_imu_msg(msg) -> bytes:
    """:class:`Imu` -> sensor_msgs/msg/Imu CDR."""
    e = _CdrEnc()
    e.header(msg.stamp, "fcu")
    e.f64s(msg.orientation)
    e.f64s([0.0] * 9)
    e.f64s(msg.angular_velocity)
    e.f64s([0.0] * 9)
    e.f64s([0.0] * 3)  # linear acceleration
    e.f64s([0.0] * 9)
    return e.bytes()


def encode_odometry_msg(msg) -> bytes:
    """:class:`Odometry` -> nav_msgs/msg/Odometry CDR."""
    e = _CdrEnc()
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
    """:class:`Float64Stamped` -> mrs_msgs/msg/Float64Stamped CDR."""
    e = _CdrEnc()
    e.header(msg.stamp, "")
    e.f64(float(msg.value))
    return e.bytes()


class Bag2Writer:
    """Minimal rosbag2 writer: one sqlite3 (``.db3``) storage file in a bag
    directory plus ``metadata.yaml`` — the standard layout stock ROS2
    tooling (``ros2 bag info/play``) and this module's :class:`Bag2Reader`
    both open.  The ROS2 twin of :class:`.rosbag.BagWriter`: exists so
    synthetic flights (``FlightSimulator.record_bag2``) archive through the
    SAME offline path real ROS2 flight recordings replay from
    (:func:`replay_bag2`).

    Schema written: the rosbag2 sqlite3 storage's ``topics`` /
    ``messages`` tables (storage v2 core, read by every storage version)
    plus the v3+ ``schema`` version table; messages are CDR
    (``serialization_format='cdr'``), timestamps nanoseconds."""

    def __init__(self, path: str):
        name = os.path.basename(os.path.normpath(path)) or "bag"
        os.makedirs(path, exist_ok=True)
        self._dir = path
        self._rel = f"{name}_0.db3"
        fname = os.path.join(path, self._rel)
        if os.path.exists(fname):
            os.remove(fname)  # never append into a stale storage file
        self._con = sqlite3.connect(fname)
        self._con.executescript(
            "CREATE TABLE schema("
            "schema_version INTEGER PRIMARY KEY, ros_distro TEXT NOT NULL);"
            "CREATE TABLE topics("
            "id INTEGER PRIMARY KEY, name TEXT NOT NULL, type TEXT NOT NULL,"
            " serialization_format TEXT NOT NULL,"
            " offered_qos_profiles TEXT NOT NULL);"
            "CREATE TABLE messages("
            "id INTEGER PRIMARY KEY, topic_id INTEGER NOT NULL,"
            " timestamp INTEGER NOT NULL, data BLOB NOT NULL);"
        )
        self._con.execute(
            "INSERT INTO schema(schema_version, ros_distro) VALUES (3, '')"
        )
        self._topics: Dict[str, int] = {}
        self._types: Dict[str, str] = {}
        self._counts: Dict[str, int] = {}
        self._t_min: Optional[int] = None
        self._t_max: Optional[int] = None

    def _topic_id(self, topic: str, type_name: str) -> int:
        tid = self._topics.get(topic)
        if tid is None:
            tid = len(self._topics) + 1
            self._topics[topic] = tid
            self._types[topic] = type_name
            self._con.execute(
                "INSERT INTO topics(id, name, type, serialization_format,"
                " offered_qos_profiles) VALUES (?, ?, ?, 'cdr', '')",
                (tid, topic, type_name),
            )
        return tid

    def write(self, topic: str, type_name: str, stamp: float, raw: bytes):
        """Append one CDR-serialized message at ``stamp`` [s]."""
        tid = self._topic_id(topic, type_name)
        ts = int(round(stamp * 1e9))
        self._t_min = ts if self._t_min is None else min(self._t_min, ts)
        self._t_max = ts if self._t_max is None else max(self._t_max, ts)
        self._counts[topic] = self._counts.get(topic, 0) + 1
        self._con.execute(
            "INSERT INTO messages(topic_id, timestamp, data) VALUES (?, ?, ?)",
            (tid, ts, sqlite3.Binary(raw)),
        )

    def _metadata_yaml(self) -> str:
        t0 = self._t_min or 0
        dur = (self._t_max or 0) - t0
        lines = [
            "rosbag2_bagfile_information:",
            "  version: 5",
            "  storage_identifier: sqlite3",
            "  relative_file_paths:",
            f"    - {self._rel}",
            "  duration:",
            f"    nanoseconds: {dur}",
            "  starting_time:",
            f"    nanoseconds_since_epoch: {t0}",
            f"  message_count: {sum(self._counts.values())}",
            "  topics_with_message_count:",
        ]
        for topic, tid in sorted(self._topics.items(), key=lambda kv: kv[1]):
            lines += [
                "    - topic_metadata:",
                f"        name: {topic}",
                f"        type: {self._types[topic]}",
                "        serialization_format: cdr",
                "        offered_qos_profiles: \"\"",
                f"      message_count: {self._counts.get(topic, 0)}",
            ]
        lines += [
            "  compression_format: \"\"",
            "  compression_mode: \"\"",
            "  files:",
            f"    - path: {self._rel}",
            f"      starting_time:",
            f"        nanoseconds_since_epoch: {t0}",
            "      duration:",
            f"        nanoseconds: {dur}",
            f"      message_count: {sum(self._counts.values())}",
            "",
        ]
        return "\n".join(lines)

    def close(self):
        if self._con is not None:
            self._con.commit()
            self._con.close()
            self._con = None
            with open(os.path.join(self._dir, "metadata.yaml"), "w") as fh:
                fh.write(self._metadata_yaml())

    def __enter__(self) -> "Bag2Writer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
