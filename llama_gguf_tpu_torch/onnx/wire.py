"""Minimal protobuf wire-format reader and writer for the ONNX subset the
loader needs (port of llama_gguf_tpu/onnx/wire.py): ModelProto.graph,
GraphProto.{node,initializer}, TensorProto.{dims,data_type,raw_data,
float_data,int64_data,name,external_data,data_location} and
NodeProto.{input,output,name,op_type}, with no codegen and no onnx package.
The writer half builds fixtures: ``tensor_proto``, ``node_proto`` and
``write_model`` write an HF-Optimum-style export from numpy arrays.
"""

from __future__ import annotations

from typing import Any, Iterator


def read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: memoryview) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value). Length-delimited values are
    memoryviews; varints are ints; fixed are raw bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = bytes(buf[pos: pos + 8])
            pos += 8
        elif wtype == 2:  # length-delimited
            length, pos = read_varint(buf, pos)
            val = buf[pos: pos + length]
            pos += length
        elif wtype == 5:  # 32-bit
            val = bytes(buf[pos: pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield field, wtype, val


def packed_varints(buf: memoryview) -> list[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = read_varint(buf, pos)
        out.append(v)
    return out


def zigzag(v: int, bits: int = 64) -> int:
    """Interpret a varint as two's-complement signed (proto int64)."""
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


# -- writer (tests/fixtures) -----------------------------------------------------


def write_varint(v: int) -> bytes:
    out = bytearray()
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_varint(num: int, v: int) -> bytes:
    return write_varint(num << 3) + write_varint(v)


def field_bytes(num: int, data: bytes) -> bytes:
    return write_varint((num << 3) | 2) + write_varint(len(data)) + data


def field_str(num: int, s: str) -> bytes:
    return field_bytes(num, s.encode())


def tensor_proto(name: str, arr, external: str | None = None,
                 offset: int = 0) -> bytes:
    """A float32 TensorProto: inline raw_data, or (``external``) the
    location, offset and length of its bytes in an external data file."""
    import numpy as np

    arr = np.ascontiguousarray(arr, np.float32)
    out = b"".join(field_varint(1, d) for d in arr.shape)
    out += field_varint(2, 1)  # FLOAT
    out += field_str(8, name)
    if external is None:
        return out + field_bytes(9, arr.tobytes())
    for k, v in (("location", external), ("offset", str(offset)),
                 ("length", str(arr.size * 4))):
        out += field_bytes(13, field_str(1, k) + field_str(2, v))
    return out + field_varint(14, 1)  # EXTERNAL


def node_proto(op: str, name: str, inputs: list[str],
               outputs: list[str]) -> bytes:
    return (b"".join(field_str(1, i) for i in inputs)
            + b"".join(field_str(2, o) for o in outputs)
            + field_str(3, name) + field_str(4, op))


def write_model(path: str, tensors: dict, nodes: list[bytes] = (),
                external: str | None = None) -> str:
    """Write a ModelProto (ir_version 8) whose graph holds ``tensors``
    (name -> float32 array) as initializers and the given NodeProtos;
    ``external``: the initializers' bytes go to that file beside ``path``
    instead."""
    import os

    graph, blob = b"", b""
    for name, arr in tensors.items():
        if external is None:
            graph += field_bytes(5, tensor_proto(name, arr))
        else:
            graph += field_bytes(5, tensor_proto(name, arr, external,
                                                 len(blob)))
            blob += arr.astype("<f4").tobytes()
    graph += b"".join(field_bytes(1, n) for n in nodes)
    with open(path, "wb") as f:
        f.write(field_varint(1, 8) + field_bytes(7, graph))
    if external is not None:
        with open(os.path.join(os.path.dirname(os.path.abspath(path)),
                               external), "wb") as f:
            f.write(blob)
    return path
