"""Dependency-free ONNX protobuf wire-format codec (writer + reader).

The port's copy of rave_tpu/export/onnx_proto.py (numpy only), so that the
port needs nothing of the JAX package; tests/test_torch_onnx.py holds the
two writers to equal bytes. No `onnx` package is needed: ModelProto bytes
are written directly in the protobuf wire format (varint /
length-delimited encoding). Only the message subset the exporter needs is
implemented; field numbers follow the public onnx.proto3 schema (IR
version 7 / opset 12, the opset the reference emits in
scripts/export_onnx.py:76-91).

Wire format refresher: each field is a tag varint ((field_num << 3) |
wire_type) followed by the payload. Wire types: 0 = varint, 1 = 64-bit,
2 = length-delimited (bytes/strings/sub-messages/packed), 5 = 32-bit.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

IR_VERSION = 7
OPSET_VERSION = 12

# TensorProto.DataType
FLOAT = 1
INT64 = 7

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8


# --------------------------------------------------------------------------
# low-level writer
# --------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # protobuf encodes negative int64 as 10-byte varint
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fieldnum: int, wiretype: int) -> bytes:
    return _varint((fieldnum << 3) | wiretype)


def w_varint(fieldnum: int, value: int) -> bytes:
    return _tag(fieldnum, 0) + _varint(int(value))


def w_bytes(fieldnum: int, payload: bytes) -> bytes:
    return _tag(fieldnum, 2) + _varint(len(payload)) + payload


def w_str(fieldnum: int, s: str) -> bytes:
    return w_bytes(fieldnum, s.encode("utf-8"))


def w_float(fieldnum: int, f: float) -> bytes:
    return _tag(fieldnum, 5) + struct.pack("<f", f)


# --------------------------------------------------------------------------
# message builders (return serialized bytes)
# --------------------------------------------------------------------------


def tensor_proto(
    name: str, arr: np.ndarray, data_type: Optional[int] = None
) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    if data_type is None:
        data_type = INT64 if arr.dtype.kind == "i" else FLOAT
    np_dtype = np.int64 if data_type == INT64 else np.float32
    arr = np.ascontiguousarray(arr, dtype=np_dtype)
    out = b"".join(w_varint(1, d) for d in arr.shape)
    out += w_varint(2, data_type)
    out += w_str(8, name)
    out += w_bytes(9, arr.tobytes())  # little-endian raw data
    return out


def _dim(v) -> bytes:
    # TensorShapeProto.Dimension: dim_value=1, dim_param=2
    if isinstance(v, str):
        return w_str(2, v)
    return w_varint(1, int(v))


def value_info(name: str, elem_type: int, shape: Tuple) -> bytes:
    """ValueInfoProto{name=1, type=2}; TypeProto{tensor_type=1};
    Tensor{elem_type=1, shape=2}; TensorShapeProto{dim=1}."""
    shape_msg = b"".join(w_bytes(1, _dim(d)) for d in shape)
    tensor = w_varint(1, elem_type) + w_bytes(2, shape_msg)
    typ = w_bytes(1, tensor)
    return w_str(1, name) + w_bytes(2, typ)


def attribute(name: str, value: Any) -> bytes:
    """AttributeProto{name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20}."""
    out = w_str(1, name)
    if isinstance(value, bool):
        out += w_varint(3, int(value)) + w_varint(20, ATTR_INT)
    elif isinstance(value, int):
        out += w_varint(3, value) + w_varint(20, ATTR_INT)
    elif isinstance(value, float):
        out += w_float(2, value) + w_varint(20, ATTR_FLOAT)
    elif isinstance(value, str):
        out += w_bytes(4, value.encode()) + w_varint(20, ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += w_bytes(5, tensor_proto("", value)) + w_varint(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            out += b"".join(_tag(7, 5) + struct.pack("<f", v) for v in value)
            out += w_varint(20, ATTR_FLOATS)
        else:
            out += b"".join(w_varint(8, int(v)) for v in value)
            out += w_varint(20, ATTR_INTS)
    else:
        raise TypeError(f"unsupported attribute type {type(value)} for {name}")
    return out


def node(
    op_type: str,
    inputs: List[str],
    outputs: List[str],
    name: str = "",
    **attrs,
) -> bytes:
    """NodeProto{input=1, output=2, name=3, op_type=4, attribute=5}."""
    out = b"".join(w_str(1, i) for i in inputs)
    out += b"".join(w_str(2, o) for o in outputs)
    if name:
        out += w_str(3, name)
    out += w_str(4, op_type)
    out += b"".join(w_bytes(5, attribute(k, v)) for k, v in attrs.items())
    return out


def graph(
    nodes: List[bytes],
    name: str,
    inputs: List[bytes],
    outputs: List[bytes],
    initializers: List[bytes],
    doc: str = "",
) -> bytes:
    """GraphProto{node=1, name=2, initializer=5, doc_string=10, input=11,
    output=12}."""
    out = b"".join(w_bytes(1, n) for n in nodes)
    out += w_str(2, name)
    out += b"".join(w_bytes(5, t) for t in initializers)
    if doc:
        out += w_str(10, doc)
    out += b"".join(w_bytes(11, i) for i in inputs)
    out += b"".join(w_bytes(12, o) for o in outputs)
    return out


def model(graph_bytes: bytes, producer: str = "rave_tpu", doc: str = "") -> bytes:
    """ModelProto{ir_version=1, producer_name=2, producer_version=3,
    model_version=5, doc_string=6, graph=7, opset_import=8};
    OperatorSetIdProto{domain=1, version=2}."""
    opset = w_str(1, "") + w_varint(2, OPSET_VERSION)
    out = w_varint(1, IR_VERSION)
    out += w_str(2, producer)
    out += w_str(3, "0.1")
    out += w_varint(5, 1)
    if doc:
        out += w_str(6, doc)
    out += w_bytes(7, graph_bytes)
    out += w_bytes(8, opset)
    return out


# --------------------------------------------------------------------------
# generic reader
# --------------------------------------------------------------------------


def parse(data: bytes) -> Dict[int, List[Tuple[int, Any]]]:
    """Parse a protobuf message into {field_num: [(wiretype, value), ...]}.
    Length-delimited values stay as raw bytes (call parse again to descend)."""
    out: Dict[int, List[Tuple[int, Any]]] = {}
    i, n = 0, len(data)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            tag |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        fieldnum, wt = tag >> 3, tag & 7
        if wt == 0:
            v = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            value: Any = v
        elif wt == 2:
            ln = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            value = data[i : i + ln]
            i += ln
        elif wt == 5:
            value = struct.unpack("<f", data[i : i + 4])[0]
            i += 4
        elif wt == 1:
            value = struct.unpack("<d", data[i : i + 8])[0]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.setdefault(fieldnum, []).append((wt, value))
    return out


def _one(msg, fieldnum, default=None):
    vals = msg.get(fieldnum)
    return vals[0][1] if vals else default


def _many(msg, fieldnum):
    return [v for _, v in msg.get(fieldnum, [])]


@dataclass
class Tensor:
    name: str
    dims: Tuple[int, ...]
    data_type: int
    array: np.ndarray


@dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str
    attrs: Dict[str, Any]


@dataclass
class Graph:
    name: str
    nodes: List[Node]
    initializers: Dict[str, Tensor]
    inputs: List[Tuple[str, List]]  # (name, dims with str for dynamic)
    outputs: List[Tuple[str, List]]


def decode_tensor(data: bytes) -> Tensor:
    msg = parse(data)
    dims = tuple(_many(msg, 1))
    dt = _one(msg, 2, FLOAT)
    name = _one(msg, 8, b"").decode()
    raw = _one(msg, 9)
    if raw is not None:
        np_dt = np.int64 if dt == INT64 else np.float32
        arr = np.frombuffer(raw, dtype=np_dt).reshape(dims)
    elif dt == INT64 and 7 in msg:  # int64_data fallback (torch emits this)
        arr = np.asarray(_many(msg, 7), np.int64).reshape(dims)
    elif dt == FLOAT and 4 in msg:  # float_data fallback
        arr = np.asarray(_many(msg, 4), np.float32).reshape(dims)
    else:
        arr = np.zeros(dims, np.float32)
    return Tensor(name, dims, dt, arr)


def _decode_attr(data: bytes) -> Tuple[str, Any]:
    msg = parse(data)
    name = _one(msg, 1, b"").decode()
    at = _one(msg, 20, 0)
    if at == ATTR_FLOAT:
        return name, _one(msg, 2)
    if at == ATTR_INT:
        return name, _signed(_one(msg, 3, 0))
    if at == ATTR_STRING:
        return name, _one(msg, 4, b"").decode()
    if at == ATTR_TENSOR:
        return name, decode_tensor(_one(msg, 5))
    if at == ATTR_FLOATS:
        return name, [v for _, v in msg.get(7, [])]
    if at == ATTR_INTS:
        return name, [_signed(v) for _, v in msg.get(8, [])]
    return name, None


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def decode_node(data: bytes) -> Node:
    msg = parse(data)
    return Node(
        op_type=_one(msg, 4, b"").decode(),
        inputs=[b.decode() for b in _many(msg, 1)],
        outputs=[b.decode() for b in _many(msg, 2)],
        name=_one(msg, 3, b"").decode(),
        attrs=dict(_decode_attr(a) for a in _many(msg, 5)),
    )


def _decode_value_info(data: bytes) -> Tuple[str, List]:
    msg = parse(data)
    name = _one(msg, 1, b"").decode()
    dims: List = []
    typ = msg.get(2)
    if typ:
        t = parse(typ[0][1])
        tt = t.get(1)
        if tt:
            tensor = parse(tt[0][1])
            shp = tensor.get(2)
            if shp:
                for _, dmsg in parse(shp[0][1]).get(1, []):
                    d = parse(dmsg)
                    if 2 in d:
                        dims.append(_one(d, 2).decode())
                    else:
                        dims.append(_one(d, 1, 0))
    return name, dims


def decode_graph(data: bytes) -> Graph:
    msg = parse(data)
    inits = [decode_tensor(t) for t in _many(msg, 5)]
    return Graph(
        name=_one(msg, 2, b"").decode(),
        nodes=[decode_node(n) for n in _many(msg, 1)],
        initializers={t.name: t for t in inits},
        inputs=[_decode_value_info(v) for v in _many(msg, 11)],
        outputs=[_decode_value_info(v) for v in _many(msg, 12)],
    )


@dataclass
class Model:
    ir_version: int
    opset: int
    producer: str
    graph: Graph


def decode_model(data: bytes) -> Model:
    msg = parse(data)
    opset = 0
    for op in _many(msg, 8):
        opset = max(opset, _one(parse(op), 2, 0))
    return Model(
        ir_version=_one(msg, 1, 0),
        opset=opset,
        producer=_one(msg, 2, b"").decode(),
        graph=decode_graph(_one(msg, 7)),
    )
