"""GGUF v3 writer + builder.

Writes spec-compliant GGUF v3 files (metadata KV of all value types, aligned
tensor data section). Used by the re-quantizer and as the synthetic-model test
fixture generator. A copy of llama_gguf_tpu/gguf/writer.py (the port never
imports the JAX package).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, Iterable

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    align_offset,
    tensor_nbytes,
)

_GGUF_VERSION = 3

_SCALAR_PACK = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NP_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}


def infer_value_type(value: Any) -> GGUFValueType:
    if isinstance(value, bool):
        return GGUFValueType.BOOL
    if isinstance(value, int):
        if value < 0:
            return GGUFValueType.INT64 if value < -(2**31) else GGUFValueType.INT32
        if value < 2**32:
            return GGUFValueType.UINT32
        return GGUFValueType.UINT64
    if isinstance(value, float):
        return GGUFValueType.FLOAT32
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    if isinstance(value, np.generic):
        return _NP_TO_VTYPE[np.dtype(type(value))]
    raise TypeError(f"cannot infer GGUF value type for {type(value)}")


@dataclass
class _PendingTensor:
    name: str
    shape: tuple[int, ...]  # GGUF dim order (ne[0] fastest)
    ggml_type: GGMLType
    data: bytes | np.ndarray


class GGUFWriter:
    """Streaming GGUF v3 writer: add metadata + tensors, then ``write``."""

    def __init__(self, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self.metadata: list[tuple[str, Any, GGUFValueType | None]] = []
        self.tensors: list[_PendingTensor] = []
        self._names: set[str] = set()

    # -- building ------------------------------------------------------------

    def add_metadata(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        self.metadata.append((key, value, vtype))
        return self

    def add_tensor_np(self, name: str, array: np.ndarray):
        """Add an unquantized tensor from a numpy array (row-major shape)."""
        dt_map = {
            np.dtype(np.float32): GGMLType.F32,
            np.dtype(np.float16): GGMLType.F16,
            np.dtype(np.float64): GGMLType.F64,
            np.dtype(np.int8): GGMLType.I8,
            np.dtype(np.int16): GGMLType.I16,
            np.dtype(np.int32): GGMLType.I32,
            np.dtype(np.int64): GGMLType.I64,
        }
        if array.dtype not in dt_map:
            raise TypeError(f"unsupported numpy dtype {array.dtype}")
        gguf_shape = tuple(reversed(array.shape))
        return self.add_tensor_raw(
            name, gguf_shape, dt_map[array.dtype], np.ascontiguousarray(array)
        )

    def add_tensor_raw(
        self,
        name: str,
        gguf_shape: Iterable[int],
        ggml_type: GGMLType,
        data: bytes | np.ndarray,
    ):
        """Add a tensor from raw (possibly quantized) block data.

        ``gguf_shape`` is in GGUF dim order: ne[0] (fastest-varying) first.
        """
        if name in self._names:
            raise ValueError(f"duplicate tensor {name}")
        shape = tuple(int(d) for d in gguf_shape)
        n_elem = int(np.prod(shape)) if shape else 1
        expect = tensor_nbytes(ggml_type, n_elem)
        nbytes = data.nbytes if isinstance(data, np.ndarray) else len(data)
        if nbytes != expect:
            raise ValueError(
                f"tensor {name}: got {nbytes} bytes, expected {expect} "
                f"for {n_elem} x {GGMLType(ggml_type).name}"
            )
        self._names.add(name)
        self.tensors.append(_PendingTensor(name, shape, GGMLType(ggml_type), data))
        return self

    # -- serialization -------------------------------------------------------

    @staticmethod
    def _pack_string(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    @classmethod
    def _pack_value(cls, value: Any, vtype: GGUFValueType) -> bytes:
        if vtype == GGUFValueType.STRING:
            return cls._pack_string(str(value))
        if vtype == GGUFValueType.BOOL:
            return struct.pack("<B", 1 if value else 0)
        if vtype == GGUFValueType.ARRAY:
            if isinstance(value, np.ndarray):
                etype = _NP_TO_VTYPE[value.dtype.newbyteorder("=")]
                body = np.ascontiguousarray(value.astype(value.dtype.newbyteorder("<"))).tobytes()
                return struct.pack("<IQ", int(etype), value.size) + body
            seq = list(value)
            if not seq:
                etype = GGUFValueType.INT32
                return struct.pack("<IQ", int(etype), 0)
            etype = infer_value_type(seq[0])
            if etype in (GGUFValueType.UINT32, GGUFValueType.INT32, GGUFValueType.INT64, GGUFValueType.UINT64):
                # promote mixed-sign/size int lists to int64 when needed
                if any(not isinstance(v, (int, np.integer)) for v in seq):
                    raise TypeError("mixed array element types")
                lo, hi = min(seq), max(seq)
                if lo < 0 or hi >= 2**31:
                    etype = GGUFValueType.INT64 if lo < 0 else GGUFValueType.UINT64
                else:
                    etype = GGUFValueType.INT32
            out = [struct.pack("<IQ", int(etype), len(seq))]
            for v in seq:
                out.append(cls._pack_value(v, etype))
            return b"".join(out)
        return struct.pack(_SCALAR_PACK[vtype], value)

    def write(self, f: BinaryIO) -> None:
        f.write(struct.pack("<IIQQ", GGUF_MAGIC, _GGUF_VERSION, len(self.tensors), len(self.metadata)))
        for key, value, vtype in self.metadata:
            vt = vtype if vtype is not None else infer_value_type(value)
            f.write(self._pack_string(key))
            f.write(struct.pack("<I", int(vt)))
            f.write(self._pack_value(value, vt))

        # tensor infos with running aligned offsets
        offset = 0
        offsets = []
        for t in self.tensors:
            offsets.append(offset)
            f.write(self._pack_string(t.name))
            f.write(struct.pack("<I", len(t.shape)))
            for d in t.shape:
                f.write(struct.pack("<Q", d))
            f.write(struct.pack("<IQ", int(t.ggml_type), offset))
            n_elem = int(np.prod(t.shape)) if t.shape else 1
            offset = align_offset(offset + tensor_nbytes(t.ggml_type, n_elem), self.alignment)

        # pad to aligned data section start
        pos = f.tell()
        f.write(b"\x00" * (align_offset(pos, self.alignment) - pos))
        data_start = f.tell()
        for t, off in zip(self.tensors, offsets):
            pad = data_start + off - f.tell()
            f.write(b"\x00" * pad)
            if isinstance(t.data, np.ndarray):
                f.write(np.ascontiguousarray(t.data).tobytes())
            else:
                f.write(t.data)

    def write_to_path(self, path: str) -> None:
        with open(path, "wb") as f:
            self.write(f)
