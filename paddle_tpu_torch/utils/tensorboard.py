"""Hand-encoded TensorBoard event files — no tensorboard/protobuf deps.

Counterpart of ``paddle_tpu/utils/tensorboard.py``, with its own copy of
the few protobuf wire helpers that file takes from
``paddle_tpu/onnx/proto.py``.  TensorBoard's event format is small enough
to emit directly:

  * TFRecord framing: [len u64le][masked-crc32c(len)][payload]
    [masked-crc32c(payload)], crc32c = Castagnoli polynomial;
  * ``Event`` proto: wall_time (1, double), step (2, int64),
    file_version (3, string) | summary (5, message);
  * ``Summary.Value``: tag (1, string), simple_value (2, float).

``SummaryWriter`` mirrors the tensorboardX/VisualDL ``add_scalar``
surface, so ``tensorboard --logdir <dir>`` opens the output directly.
"""

from __future__ import annotations

import os
import socket
import struct
import time

__all__ = ["SummaryWriter", "read_events", "read_scalars"]

# -- protobuf wire primitives -------------------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # protobuf encodes negative ints as 10-byte varints
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(int(value))


def f_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def f_string(field: int, value: str) -> bytes:
    return f_bytes(field, value.encode("utf-8"))


def _read_varint(buf: bytes, pos: int):
    shift = 0
    val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, pos
        shift += 7


def parse_message(buf: bytes) -> dict:
    """One protobuf message as {field_number: [raw values]}: varints as
    int, length-delimited fields as bytes, fixed32 as float, fixed64 as
    double."""
    out: dict = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 1:
            val = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(val)
    return out


# -- crc32c (Castagnoli, table-driven) --------------------------------------

_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ (poly if c & 1 else 0)
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


# -- Event / Summary protos --------------------------------------------------


def _f_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", float(value))


def _f_float32(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(value))


def _event(wall_time: float, step: int = 0, file_version: str = None,
           summary: bytes = None) -> bytes:
    msg = _f_double(1, wall_time)
    if step:
        msg += f_varint(2, int(step))
    if file_version is not None:
        msg += f_string(3, file_version)
    if summary is not None:
        msg += f_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = f_string(1, tag) + _f_float32(2, value)
    return f_bytes(1, val)


# -- reader ------------------------------------------------------------------
#
# The writer above framed records for years with nothing checking its own
# output beyond "tensorboard opens it".  This reader closes the loop: it
# deframes TFRecords VERIFYING both masked CRCs (a corrupt byte fails
# loudly instead of skewing a chart) and parses the Event/Summary protos
# with the proto reader above — write scalars, read back
# (tag, step, value), asserted in tests/test_torch_observability.py.


def read_events(path: str) -> list:
    """Deframe one event file into raw Event dicts
    ``{wall_time, step, file_version, summary}`` (``summary`` is the
    still-encoded Summary message or None).  Raises ``ValueError`` on a
    truncated record or a CRC mismatch."""
    with open(path, "rb") as f:
        raw = f.read()
    out, pos = [], 0
    while pos < len(raw):
        if pos + 12 > len(raw):
            raise ValueError(f"truncated record header at byte {pos}")
        (ln,) = struct.unpack_from("<Q", raw, pos)
        (lcrc,) = struct.unpack_from("<I", raw, pos + 8)
        if lcrc != _masked_crc(raw[pos:pos + 8]):
            raise ValueError(f"length CRC mismatch at byte {pos}")
        if pos + 12 + ln + 4 > len(raw):
            raise ValueError(f"truncated record payload at byte {pos}")
        payload = raw[pos + 12:pos + 12 + ln]
        (pcrc,) = struct.unpack_from("<I", raw, pos + 12 + ln)
        if pcrc != _masked_crc(payload):
            raise ValueError(f"payload CRC mismatch at byte {pos}")
        pos += 12 + ln + 4
        msg = parse_message(payload)
        out.append({
            "wall_time": msg.get(1, [0.0])[0],
            "step": int(msg.get(2, [0])[0]),
            "file_version": (msg[3][0].decode()
                             if 3 in msg else None),
            "summary": msg.get(5, [None])[0],
        })
    return out


def read_scalars(path_or_dir: str) -> dict:
    """Read every scalar out of an event file — or out of every
    ``events.out.tfevents.*`` under a log dir — as
    ``{tag: [(step, value), ...]}`` in write order."""
    if os.path.isdir(path_or_dir):
        paths = sorted(
            os.path.join(path_or_dir, f) for f in os.listdir(path_or_dir)
            if f.startswith("events.out.tfevents."))
    else:
        paths = [path_or_dir]
    out: dict = {}
    for path in paths:
        for ev in read_events(path):
            if ev["summary"] is None:
                continue
            summ = parse_message(ev["summary"])
            for val_msg in summ.get(1, []):
                val = parse_message(val_msg)
                if 1 not in val or 2 not in val:
                    continue      # not a simple_value summary
                tag = val[1][0].decode()
                out.setdefault(tag, []).append(
                    (ev["step"], float(val[2][0])))
    return out


class SummaryWriter:
    """Minimal ``add_scalar`` writer producing real TB event files."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname() or "host"
        self._path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}.{host}")
        self._f = open(self._path, "ab")
        self._f.write(_record(_event(time.time(),
                                     file_version="brain.Event:2")))
        self._f.flush()

    def add_scalar(self, tag: str, value, step: int = 0,
                   walltime: float = None):
        v = float(value.item() if hasattr(value, "item") else value)
        self._f.write(_record(_event(
            walltime if walltime is not None else time.time(),
            step=step, summary=_scalar_summary(tag, v))))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
