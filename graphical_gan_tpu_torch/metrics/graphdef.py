"""A pure-Python reader of frozen TensorFlow ``GraphDef`` protos
(``graphical_gan_tpu/metrics/graphdef.py``, the port's own copy).

The reference's inception score loads the frozen Inception-2015 GraphDef
(``tflib/inception_score.py:56-76``). The port runs that graph without
TensorFlow or protobuf, so it needs only a reader for the few proto
messages a frozen inference graph uses: nodes, string/int/float/bool/shape
attributes and Const tensors. This module reads exactly that subset of the
protobuf wire format and returns plain-Python ``Node`` objects with numpy
Const values, the same values and the same Const bits as the JAX
package's reader.

Wire format: each field is keyed by the varint ``(field_number << 3 |
wire_type)``; GraphDef uses wire types 0 (varint), 1 (64-bit), 2
(length-delimited) and 5 (32-bit). Repeated scalars may come packed (type
2) or unpacked.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# TF DataType enum values (tensorflow/core/framework/types.proto)
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8 = 1, 2, 3, 4
DT_INT16, DT_INT8, DT_STRING, DT_INT64, DT_BOOL = 5, 6, 7, 9, 10
DT_UINT16, DT_HALF, DT_UINT32, DT_UINT64 = 17, 19, 22, 23

_NUMPY_DTYPE = {
    DT_FLOAT: np.float32, DT_DOUBLE: np.float64, DT_INT32: np.int32,
    DT_UINT8: np.uint8, DT_INT16: np.int16, DT_INT8: np.int8,
    DT_INT64: np.int64, DT_BOOL: np.bool_, DT_UINT16: np.uint16,
    DT_HALF: np.float16, DT_UINT32: np.uint32, DT_UINT64: np.uint64,
}


def dtype_to_numpy(dt: int):
    if dt not in _NUMPY_DTYPE:
        raise ValueError(f"unsupported TF DataType enum {dt}")
    return _NUMPY_DTYPE[dt]


# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer: value
    is an int for wire types 0, 1 and 5 (1 and 5 as their raw
    little-endian bits) and bytes for type 2."""
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wtype == 5:
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _as_signed(v: int, bits: int = 64) -> int:
    return v - (1 << bits) if v >= (1 << (bits - 1)) else v


def _f32(v: int) -> float:
    return struct.unpack("<f", v.to_bytes(4, "little"))[0]


def _packed_varints(data: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# message readers (GraphDef subset)
# ---------------------------------------------------------------------------

def _read_shape(buf: bytes) -> Optional[List[int]]:
    """TensorShapeProto: dim=2 (size=1), unknown_rank=3."""
    dims: List[int] = []
    unknown = False
    for fnum, _, val in _fields(buf):
        if fnum == 2:
            size = 0
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    size = _as_signed(v2)
            dims.append(size)
        elif fnum == 3 and val:
            unknown = True
    return None if unknown else dims


def _read_tensor(buf: bytes) -> np.ndarray:
    """TensorProto: dtype=1, tensor_shape=2, tensor_content=4,
    float_val=5, double_val=6, int_val=7, string_val=8, int64_val=10,
    bool_val=11, half_val=13."""
    dtype = DT_FLOAT
    shape: List[int] = []
    content = b""
    floats: List[float] = []
    doubles: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    int64s: List[int] = []
    bools: List[bool] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            dtype = val
        elif fnum == 2:
            shape = _read_shape(val) or []
        elif fnum == 4:
            content = val
        elif fnum == 5:
            if wtype == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(_f32(val))
        elif fnum == 6:
            if wtype == 2:
                doubles.extend(struct.unpack(f"<{len(val) // 8}d", val))
            else:
                doubles.append(struct.unpack(
                    "<d", int(val).to_bytes(8, "little"))[0])
        elif fnum == 7:
            ints.extend(_packed_varints(val) if wtype == 2
                        else [_as_signed(val, 32)])
        elif fnum == 8:
            strings.append(val)
        elif fnum == 10:
            int64s.extend(_packed_varints(val) if wtype == 2
                          else [_as_signed(val)])
        elif fnum == 11:
            bools.extend([bool(b) for b in _packed_varints(val)]
                         if wtype == 2 else [bool(val)])
    if dtype == DT_STRING:
        arr = np.array(strings, dtype=object)
        return arr.reshape(shape) if shape else arr
    np_dtype = dtype_to_numpy(dtype)
    n = int(np.prod(shape)) if shape else 1
    if content:
        arr = np.frombuffer(content, dtype=np_dtype).copy()
    else:
        vals = (floats if dtype == DT_FLOAT else
                doubles if dtype == DT_DOUBLE else
                bools if dtype == DT_BOOL else
                int64s if dtype == DT_INT64 else ints)
        vals = [_as_signed(v, 32) if dtype == DT_INT32
                and isinstance(v, int) else v for v in vals]
        arr = np.asarray(vals, dtype=np_dtype)
        if arr.size == 1 and n > 1:
            arr = np.full((n,), arr.reshape(-1)[0], dtype=np_dtype)
        if arr.size == 0 and n > 0:
            arr = np.zeros((n,), dtype=np_dtype)
    return arr.reshape(shape)


@dataclass
class Attr:
    """One decoded AttrValue (exactly one member set)."""
    s: Optional[bytes] = None
    i: Optional[int] = None
    f: Optional[float] = None
    b: Optional[bool] = None
    type: Optional[int] = None
    shape: Optional[List[int]] = None
    tensor: Optional[np.ndarray] = None
    list_s: Optional[List[bytes]] = None
    list_i: Optional[List[int]] = None
    list_f: Optional[List[float]] = None
    list_type: Optional[List[int]] = None


def _read_attr_value(buf: bytes) -> Attr:
    """AttrValue: list=1, s=2, i=3, f=4, b=5, type=6, shape=7, tensor=8."""
    a = Attr()
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            a.list_s, a.list_i, a.list_f, a.list_type = [], [], [], []
            for f2, w2, v2 in _fields(val):
                if f2 == 2:
                    a.list_s.append(v2)
                elif f2 == 3:
                    a.list_i.extend(_packed_varints(v2) if w2 == 2
                                    else [_as_signed(v2)])
                elif f2 == 4:
                    if w2 == 2:
                        a.list_f.extend(
                            struct.unpack(f"<{len(v2) // 4}f", v2))
                    else:
                        a.list_f.append(_f32(v2))
                elif f2 == 6:
                    a.list_type.extend(_packed_varints(v2) if w2 == 2
                                       else [v2])
        elif fnum == 2:
            a.s = val
        elif fnum == 3:
            a.i = _as_signed(val)
        elif fnum == 4:
            a.f = _f32(val)
        elif fnum == 5:
            a.b = bool(val)
        elif fnum == 6:
            a.type = val
        elif fnum == 7:
            a.shape = _read_shape(val)
        elif fnum == 8:
            a.tensor = _read_tensor(val)
    return a


@dataclass
class Node:
    name: str
    op: str
    inputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Attr] = field(default_factory=dict)

    def attr(self, key: str, default: Any = None) -> Any:
        a = self.attrs.get(key)
        if a is None:
            return default
        for v in (a.tensor, a.s, a.i, a.f, a.b, a.type, a.shape,
                  a.list_i, a.list_f, a.list_s, a.list_type):
            if v is not None:
                return v
        return default


def _read_node(buf: bytes) -> Node:
    """NodeDef: name=1, op=2, input=3, device=4, attr=5 (map entry)."""
    node = Node(name="", op="")
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            node.name = val.decode("utf-8")
        elif fnum == 2:
            node.op = val.decode("utf-8")
        elif fnum == 3:
            node.inputs.append(val.decode("utf-8"))
        elif fnum == 5:
            key, attr = "", Attr()
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    key = v2.decode("utf-8")
                elif f2 == 2:
                    attr = _read_attr_value(v2)
            node.attrs[key] = attr
    return node


def parse_graphdef(data: bytes) -> List[Node]:
    """GraphDef: node=1 repeated."""
    return [_read_node(val) for fnum, _, val in _fields(data) if fnum == 1]


def load_graphdef(path: str) -> List[Node]:
    with open(path, "rb") as f:
        return parse_graphdef(f.read())
