"""A minimal protobuf wire-format codec for ONNX messages.

Counterpart of ``paddle_tpu/onnx/proto.py``: no ``onnx`` package is
needed, so the exporter writes ONNX's protobuf messages by hand (varint
tags, varint ints, length-delimited submessages; see
https://protobuf.dev/programming-guides/encoding/).  The field numbers
follow onnx/onnx.proto3 (IR version 8): ModelProto.graph = 7,
GraphProto.node = 1, NodeProto.op_type = 4, TensorProto.raw_data = 9 ...

Only what the exporter and the runner's reader need is here.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

# -- wire primitives --------------------------------------------------------


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


def f_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(value))


def f_packed_varints(field: int, values) -> bytes:
    payload = b"".join(_varint(int(v)) for v in values)
    return f_bytes(field, payload)


def f_packed_floats(field: int, values) -> bytes:
    payload = b"".join(struct.pack("<f", float(v)) for v in values)
    return f_bytes(field, payload)


# -- reader (the runner, the tests) -----------------------------------------


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, pos
        shift += 7


def parse_message(buf: bytes) -> Dict[int, List]:
    """Parse one protobuf message into {field_number: [raw values]}.
    Length-delimited fields come back as bytes (parse nested messages by
    calling parse_message again); varints as int; fixed32 as float bits."""
    out: Dict[int, List] = {}
    pos = 0
    while pos < len(buf):
        key, pos = read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = read_varint(buf, pos)
        elif wire == 2:
            ln, pos = read_varint(buf, pos)
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


# -- ONNX message builders (field numbers from onnx.proto3) -----------------

# TensorProto.DataType
DTYPE = {"float32": 1, "uint8": 2, "int8": 3, "int32": 6, "int64": 7,
         "bool": 9, "float16": 10, "float64": 11, "bfloat16": 16}

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS = 6, 7


def tensor(name: str, dims, data_type: int, raw: bytes) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    msg = b"".join(f_varint(1, d) for d in dims)
    msg += f_varint(2, data_type)
    msg += f_string(8, name)
    msg += f_bytes(9, raw)
    return msg


def attribute(name: str, value) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    type=20."""
    msg = f_string(1, name)
    if isinstance(value, bool):
        msg += f_varint(3, int(value)) + f_varint(20, ATTR_INT)
    elif isinstance(value, int):
        msg += f_varint(3, value) + f_varint(20, ATTR_INT)
    elif isinstance(value, float):
        msg += f_float(2, value) + f_varint(20, ATTR_FLOAT)
    elif isinstance(value, str):
        msg += f_bytes(4, value.encode()) + f_varint(20, ATTR_STRING)
    elif isinstance(value, bytes):
        # pre-encoded TensorProto
        msg += f_bytes(5, value) + f_varint(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            msg += b"".join(f_float(7, v) for v in value)
            msg += f_varint(20, ATTR_FLOATS)
        else:
            msg += b"".join(f_varint(8, int(v)) for v in value)
            msg += f_varint(20, ATTR_INTS)
    else:
        raise TypeError(f"unsupported attribute value {value!r}")
    return msg


def node(op_type: str, inputs, outputs, name: str = "",
         attrs: Dict = None) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    msg = b"".join(f_string(1, i) for i in inputs)
    msg += b"".join(f_string(2, o) for o in outputs)
    if name:
        msg += f_string(3, name)
    msg += f_string(4, op_type)
    for k, v in (attrs or {}).items():
        msg += f_bytes(5, attribute(k, v))
    return msg


def value_info(name: str, elem_type: int, shape) -> bytes:
    """ValueInfoProto: name=1, type=2; TypeProto.tensor_type=1;
    Tensor.elem_type=1, shape=2; TensorShapeProto.dim=1;
    Dimension.dim_value=1, dim_param=2."""
    dims = b""
    for d in shape:
        if d is None or (isinstance(d, int) and d < 0):
            dim = f_string(2, "batch")
        else:
            dim = f_varint(1, int(d))
        dims += f_bytes(1, dim)
    tensor_type = f_varint(1, elem_type) + f_bytes(2, dims)
    type_proto = f_bytes(1, tensor_type)
    return f_string(1, name) + f_bytes(2, type_proto)


def graph(nodes: List[bytes], name: str, initializers: List[bytes],
          inputs: List[bytes], outputs: List[bytes]) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    msg = b"".join(f_bytes(1, n) for n in nodes)
    msg += f_string(2, name)
    msg += b"".join(f_bytes(5, t) for t in initializers)
    msg += b"".join(f_bytes(11, v) for v in inputs)
    msg += b"".join(f_bytes(12, v) for v in outputs)
    return msg


def model(graph_msg: bytes, opset_version: int = 13,
          producer: str = "paddle_tpu_torch") -> bytes:
    """ModelProto: ir_version=1, producer_name=2, graph=7,
    opset_import=8 (OperatorSetIdProto: domain=1, version=2)."""
    opset = f_string(1, "") + f_varint(2, opset_version)
    msg = f_varint(1, 8)  # IR version 8
    msg += f_string(2, producer)
    msg += f_bytes(7, graph_msg)
    msg += f_bytes(8, opset)
    return msg
