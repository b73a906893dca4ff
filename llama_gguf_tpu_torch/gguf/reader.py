"""GGUF reader: mmap-backed parse of header, metadata KV, and tensor infos.

Supports GGUF v1 (32-bit counts/lengths), v2 and v3 (64-bit), all 13 metadata
value types including nested arrays, and zero-copy tensor access into the
mmap. A copy of llama_gguf_tpu/gguf/reader.py (the port never imports the
JAX package).
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    align_offset,
    tensor_nbytes,
)


class GGUFError(Exception):
    pass


@dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]  # GGUF order: fastest-varying dim first (ne[0]..)
    ggml_type: GGMLType
    offset: int  # relative to start of the data section

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return tensor_nbytes(self.ggml_type, self.n_elements)

    @property
    def np_shape(self) -> tuple[int, ...]:
        """Row-major numpy shape (GGUF dims reversed)."""
        return tuple(reversed(self.shape))


_SCALAR_FMT = {
    GGUFValueType.UINT8: ("<B", 1),
    GGUFValueType.INT8: ("<b", 1),
    GGUFValueType.UINT16: ("<H", 2),
    GGUFValueType.INT16: ("<h", 2),
    GGUFValueType.UINT32: ("<I", 4),
    GGUFValueType.INT32: ("<i", 4),
    GGUFValueType.FLOAT32: ("<f", 4),
    GGUFValueType.BOOL: ("<B", 1),
    GGUFValueType.UINT64: ("<Q", 8),
    GGUFValueType.INT64: ("<q", 8),
    GGUFValueType.FLOAT64: ("<d", 8),
}

_ARRAY_NP_DTYPE = {
    GGUFValueType.UINT8: np.uint8,
    GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16,
    GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32,
    GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32,
    GGUFValueType.UINT64: np.uint64,
    GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
}


class _Cursor:
    """Sequential little-endian decoder over a bytes-like buffer."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise GGUFError(f"unexpected EOF at {self.pos}+{n}")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def scalar(self, vtype: GGUFValueType) -> Any:
        fmt, size = _SCALAR_FMT[vtype]
        v = struct.unpack(fmt, self.read(size))[0]
        if vtype == GGUFValueType.BOOL:
            return bool(v)
        return v


@dataclass
class GGUFFile:
    """A parsed GGUF file with mmap'd tensor data.

    ``metadata`` maps key -> python value (str/int/float/bool/list/np.ndarray).
    Long homogeneous numeric arrays decode to numpy arrays; string arrays to
    lists of str.
    """

    path: str
    version: int
    alignment: int
    metadata: dict[str, Any]
    tensors: dict[str, TensorInfo]
    tensor_order: list[str]
    data_offset: int
    _mmap: mmap.mmap | None = field(default=None, repr=False)
    _file: BinaryIO | None = field(default=None, repr=False)

    # -- construction --------------------------------------------------------

    @classmethod
    def open(cls, path: str | os.PathLike) -> "GGUFFile":
        f = open(path, "rb")
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except Exception:
            f.close()
            raise
        try:
            return cls._parse(str(path), f, mm)
        except Exception:
            mm.close()
            f.close()
            raise

    @classmethod
    def from_bytes(cls, data: bytes, path: str = "<bytes>") -> "GGUFFile":
        return cls._parse(path, None, data)

    @classmethod
    def _parse(cls, path: str, f, buf) -> "GGUFFile":
        cur = _Cursor(buf)
        magic = cur.u32()
        if magic != GGUF_MAGIC:
            raise GGUFError(f"bad magic 0x{magic:08x} (not a GGUF file)")
        version = cur.u32()
        if version not in (1, 2, 3):
            raise GGUFError(f"unsupported GGUF version {version}")
        wide = version >= 2  # v1 used u32 counts and lengths

        def count() -> int:
            return cur.u64() if wide else cur.u32()

        def read_string() -> str:
            n = count()
            return cur.read(n).decode("utf-8", errors="replace")

        def read_value(vtype: GGUFValueType) -> Any:
            if vtype == GGUFValueType.STRING:
                return read_string()
            if vtype == GGUFValueType.ARRAY:
                etype = GGUFValueType(cur.u32())
                n = count()
                if etype in _ARRAY_NP_DTYPE:
                    dt = np.dtype(_ARRAY_NP_DTYPE[etype]).newbyteorder("<")
                    raw = cur.read(n * dt.itemsize)
                    return np.frombuffer(raw, dtype=dt, count=n)
                if etype == GGUFValueType.BOOL:
                    raw = cur.read(n)
                    return [bool(b) for b in raw]
                # strings or nested arrays
                return [read_value(etype) for _ in range(n)]
            return cur.scalar(vtype)

        n_tensors = count()
        n_kv = count()

        metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = read_string()
            vtype = GGUFValueType(cur.u32())
            metadata[key] = read_value(vtype)

        alignment = int(metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))

        tensors: dict[str, TensorInfo] = {}
        order: list[str] = []
        for _ in range(n_tensors):
            name = read_string()
            n_dims = cur.u32()
            if n_dims > 4:
                raise GGUFError(f"tensor {name}: n_dims {n_dims} > 4")
            dims = tuple(count() for _ in range(n_dims))
            ttype = cur.u32()
            offset = cur.u64()
            try:
                gt = GGMLType(ttype)
            except ValueError as e:
                raise GGUFError(f"tensor {name}: unknown ggml type {ttype}") from e
            tensors[name] = TensorInfo(name, dims, gt, offset)
            order.append(name)

        data_offset = align_offset(cur.pos, alignment)
        is_mm = isinstance(buf, mmap.mmap)
        out = cls(
            path=path,
            version=version,
            alignment=alignment,
            metadata=metadata,
            tensors=tensors,
            tensor_order=order,
            data_offset=data_offset,
            _mmap=buf if is_mm else None,
            _file=f if is_mm else None,
        )
        out._buf = buf
        return out

    # -- data access ---------------------------------------------------------

    @property
    def _data(self):
        return self._buf

    def tensor_data(self, name: str) -> memoryview:
        """Raw quantized bytes of a tensor, zero-copy view into the mmap."""
        info = self.tensors[name]
        start = self.data_offset + info.offset
        end = start + info.nbytes
        data = self._data
        if end > len(data):
            raise GGUFError(f"tensor {name}: data range {start}:{end} out of file")
        return memoryview(data)[start:end]

    def tensor_bytes(self, name: str) -> np.ndarray:
        """Tensor raw bytes as a uint8 numpy array (zero-copy)."""
        return np.frombuffer(self.tensor_data(name), dtype=np.uint8)

    def get(self, key: str, default: Any = None) -> Any:
        return self.metadata.get(key, default)

    def close(self) -> None:
        if self._mmap is not None:
            try:
                self._mmap.close()
            except BufferError:
                # zero-copy views (np.frombuffer) still alive; the mmap is
                # released when they are garbage collected
                pass
            self._mmap = None
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
