"""Minimal ONNX file reader: extract initializer tensors by name.

Port copy of ``mimic3_tpu/runtime/onnx_reader.py``.  The reference runs
``generator.onnx`` through ONNX Runtime
(reference: mimic3_tts/voice.py:403-405); the port only needs the
*weights* out of that file (the graph is reimplemented in PyTorch).
The ``onnx`` package is not a dependency: this module parses the
protobuf wire format directly, which is enough to walk
``ModelProto.graph.initializer`` and ``Constant`` nodes.

Wire format: each field is a varint key ``(field_number << 3) | wire_type``
followed by a varint (type 0), 8 bytes (type 1), length-delimited bytes
(type 2), or 4 bytes (type 5).

Relevant schema (onnx.proto3):
  ModelProto:  graph = 7
  GraphProto:  node = 1, initializer = 5
  NodeProto:   output = 2, op_type = 4, attribute = 5
  AttributeProto: name = 1, t = 5 (TensorProto)
  TensorProto: dims = 1, data_type = 2, float_data = 4, int32_data = 5,
               string_data = 6, int64_data = 7, name = 8, raw_data = 9,
               double_data = 10, uint64_data = 11, external_data = 13
"""

from __future__ import annotations

import struct
import typing
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class OnnxNode:
    """A graph node's identity (enough to locate weight consumers)."""

    op_type: str = ""
    name: str = ""
    inputs: typing.List[str] = field(default_factory=list)
    outputs: typing.List[str] = field(default_factory=list)

# ONNX TensorProto.DataType -> numpy dtype (little-endian, as in raw_data)
_DTYPE_MAP: typing.Dict[int, np.dtype] = {
    1: np.dtype("<f4"),  # FLOAT
    2: np.dtype("u1"),  # UINT8
    3: np.dtype("i1"),  # INT8
    4: np.dtype("<u2"),  # UINT16
    5: np.dtype("<i2"),  # INT16
    6: np.dtype("<i4"),  # INT32
    7: np.dtype("<i8"),  # INT64
    9: np.dtype("?"),  # BOOL
    10: np.dtype("<f2"),  # FLOAT16
    11: np.dtype("<f8"),  # DOUBLE
    12: np.dtype("<u4"),  # UINT32
    13: np.dtype("<u8"),  # UINT64
}


class _Reader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: memoryview, start: int = 0, end: int = -1):
        self.buf = buf
        self.pos = start
        self.end = len(buf) if end < 0 else end

    def varint(self) -> int:
        result = 0
        shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if not (b & 0x80):
                return result
            shift += 7
            if shift > 70:
                raise ValueError("varint too long (corrupt protobuf)")

    def skip(self, wire_type: int) -> None:
        if wire_type == 0:
            self.varint()
        elif wire_type == 1:
            self.pos += 8
        elif wire_type == 2:
            n = self.varint()  # read length BEFORE advancing pos
            self.pos += n
        elif wire_type == 5:
            self.pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")

    def bytes_field(self) -> memoryview:
        n = self.varint()
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def fields(self) -> typing.Iterator[typing.Tuple[int, int]]:
        while self.pos < self.end:
            key = self.varint()
            yield key >> 3, key & 0x7


def _signed(v: int) -> int:
    """Interpret a 64-bit varint as a signed int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_tensor(
    buf: memoryview,
) -> typing.Tuple[typing.Optional[str], typing.Optional[np.ndarray]]:
    r = _Reader(buf)
    dims: typing.List[int] = []
    data_type = 1
    name: typing.Optional[str] = None
    raw: typing.Optional[memoryview] = None
    float_data: typing.List[float] = []
    int_data: typing.List[int] = []
    double_data: typing.List[float] = []
    external = False

    for field, wt in r.fields():
        if field == 1:  # dims
            if wt == 0:
                dims.append(_signed(r.varint()))
            else:  # packed
                sub = _Reader(r.bytes_field())
                while sub.pos < sub.end:
                    dims.append(_signed(sub.varint()))
        elif field == 2 and wt == 0:
            data_type = r.varint()
        elif field == 4:  # float_data
            if wt == 5:
                float_data.append(
                    struct.unpack_from("<f", r.buf, r.pos)[0]
                )
                r.pos += 4
            else:  # packed
                data = bytes(r.bytes_field())
                float_data.extend(
                    struct.unpack(f"<{len(data) // 4}f", data)
                )
        elif field in (5, 7, 11):  # int32_data / int64_data / uint64_data
            if wt == 0:
                int_data.append(_signed(r.varint()))
            else:
                sub = _Reader(r.bytes_field())
                while sub.pos < sub.end:
                    int_data.append(_signed(sub.varint()))
        elif field == 8 and wt == 2:
            name = bytes(r.bytes_field()).decode("utf-8")
        elif field == 9 and wt == 2:
            raw = r.bytes_field()
        elif field == 10:  # double_data
            if wt == 1:
                double_data.append(
                    struct.unpack_from("<d", r.buf, r.pos)[0]
                )
                r.pos += 8
            else:
                data = bytes(r.bytes_field())
                double_data.extend(
                    struct.unpack(f"<{len(data) // 8}d", data)
                )
        elif field == 13:  # external_data — unsupported, skip tensor
            external = True
            r.skip(wt)
        else:
            r.skip(wt)

    if external:
        return name, None

    shape = tuple(dims)

    if data_type == 16:  # BFLOAT16: raw 2-byte payloads, widen via uint16
        if raw is None:
            return name, None
        u16 = np.frombuffer(bytes(raw), dtype="<u2").reshape(shape)
        f32 = (u16.astype(np.uint32) << 16).view(np.float32).copy()
        return name, f32

    dtype = _DTYPE_MAP.get(data_type)
    if dtype is None:
        return name, None  # strings/complex: not weights

    if raw is not None:
        arr = np.frombuffer(bytes(raw), dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=np.float32)
    elif double_data:
        arr = np.asarray(double_data, dtype=np.float64)
    elif int_data:
        arr = np.asarray(int_data, dtype=np.int64)
    else:
        arr = np.zeros(0, dtype=dtype)

    count = int(np.prod(shape)) if shape else arr.size
    if arr.size != count:
        # segmented/partial tensor — not produced by torch exports
        return name, None
    arr = arr.astype(dtype, copy=False).reshape(shape)
    return name, arr


def _parse_attribute(
    buf: memoryview,
) -> typing.Tuple[typing.Optional[str], typing.Optional[memoryview]]:
    """Return (attr_name, tensor_bytes) for AttributeProto."""
    r = _Reader(buf)
    name: typing.Optional[str] = None
    tensor: typing.Optional[memoryview] = None
    for field, wt in r.fields():
        if field == 1 and wt == 2:
            name = bytes(r.bytes_field()).decode("utf-8")
        elif field == 5 and wt == 2:  # t: TensorProto
            tensor = r.bytes_field()
        else:
            r.skip(wt)
    return name, tensor


def _parse_node(
    buf: memoryview,
    out: typing.Dict[str, np.ndarray],
) -> OnnxNode:
    """Parse a NodeProto; extract Constant tensors (folded weights)."""
    r = _Reader(buf)
    node = OnnxNode()
    attr_tensors: typing.List[memoryview] = []
    for field, wt in r.fields():
        if field == 1 and wt == 2:  # input
            node.inputs.append(bytes(r.bytes_field()).decode("utf-8"))
        elif field == 2 and wt == 2:  # output
            node.outputs.append(bytes(r.bytes_field()).decode("utf-8"))
        elif field == 3 and wt == 2:  # name
            node.name = bytes(r.bytes_field()).decode("utf-8")
        elif field == 4 and wt == 2:  # op_type
            node.op_type = bytes(r.bytes_field()).decode("utf-8")
        elif field == 5 and wt == 2:
            attr_name, tensor = _parse_attribute(r.bytes_field())
            if attr_name == "value" and tensor is not None:
                attr_tensors.append(tensor)
        else:
            r.skip(wt)
    if node.op_type == "Constant" and node.outputs and attr_tensors:
        _, arr = _parse_tensor(attr_tensors[0])
        if arr is not None:
            out[node.outputs[0]] = arr
    return node


def _parse_graph(
    buf: memoryview,
) -> typing.Tuple[typing.Dict[str, np.ndarray], typing.List[OnnxNode]]:
    r = _Reader(buf)
    tensors: typing.Dict[str, np.ndarray] = {}
    nodes: typing.List[OnnxNode] = []
    for field, wt in r.fields():
        if field == 5 and wt == 2:  # initializer
            name, arr = _parse_tensor(r.bytes_field())
            if name is not None and arr is not None:
                tensors[name] = arr
        elif field == 1 and wt == 2:  # node (Constant extraction)
            nodes.append(_parse_node(r.bytes_field(), tensors))
        else:
            r.skip(wt)
    return tensors, nodes


def read_onnx_graph(
    path: typing.Union[str, Path],
) -> typing.Tuple[typing.Dict[str, np.ndarray], typing.List[OnnxNode]]:
    """Read (named weight tensors, graph nodes) out of an ONNX file.

    Nodes carry op_type/name/inputs/outputs — enough for the converter to
    recover module paths for initializers whose names a real
    ``torch.onnx.export`` anonymized (``onnx::Conv_123``-style names for
    constant-folded weight-norm weights)."""
    data = memoryview(Path(path).read_bytes())
    r = _Reader(data)
    for field, wt in r.fields():
        if field == 7 and wt == 2:  # ModelProto.graph
            return _parse_graph(r.bytes_field())
        r.skip(wt)
    raise ValueError(f"{path}: no graph found (not an ONNX model?)")


def read_onnx_initializers(
    path: typing.Union[str, Path],
) -> typing.Dict[str, np.ndarray]:
    """Read all named weight tensors out of an ONNX file."""
    return read_onnx_graph(path)[0]
