"""Sidecar cache of repacked weights: a quant load's second time is a read.

A copy of llama_gguf_tpu/quant/repack_cache.py (the port never imports the
JAX package). The repacked layouts are deterministic, so the first quant
load of a GGUF writes them to a ``<model>.repack`` sidecar beside it and
every later load maps that file (read-only numpy views) instead of
repacking.

File format: MAGIC + u32 header length + JSON header + 64-byte-aligned raw
buffers. The header records the source GGUF's (size, mtime_ns) and a format
VERSION; any mismatch (the model changed, the layout code changed)
invalidates the sidecar, and the next load rebuilds it. The array bytes
stream to a temporary file while the load runs, after HEADER_ROOM bytes
left for the header; ``flush`` writes the header there (padded with
spaces, which JSON allows, so that the data starts where the format puts
it) and renames the file over the sidecar. A header too large for the
room is written with a copy of the data behind it, as the JAX package
always writes it.

MAGIC, VERSION, the file name and the entry keys are the JAX package's, and
the entries are array-equal to its (tests/test_torch_repack_cache.py), so
either package reads the sidecar the other wrote.

LLAMA_GGUF_NO_REPACK_CACHE=1 disables it. A failure to write (an unwritable
directory, a full disk) is never fatal: the load goes on without it.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from ..gguf.constants import GGMLType
from .repack import RepackedWeight

MAGIC = b"GGTPURPK"
VERSION = 5  # the JAX package's: its layouts are the port's

_FIELDS = ("packed", "scales", "mins")
HEADER_ROOM = 1 << 20  # bytes before the data, a multiple of 64


def cache_path(gguf_path: str) -> str:
    return gguf_path + ".repack"


def _source_sig(gguf_path: str) -> dict:
    st = os.stat(gguf_path)
    return {"size": st.st_size, "mtime_ns": st.st_mtime_ns}


class RepackCache:
    """Read and write access to one model's repack sidecar."""

    def __init__(self, gguf_path: str):
        self.gguf_path = gguf_path
        self.path = cache_path(gguf_path)
        self._mmap: np.memmap | None = None
        self._index: dict[str, dict] | None = None
        # entries staged while a load builds the sidecar; their bytes are
        # already in the temporary data file
        self._pending: dict[str, dict] = {}
        self._tmp_path: str | None = None
        self._tmp_file = None
        self._tmp_pos = 0
        self._failed = False  # a staging error abandons the whole build
        self._load_index()

    @property
    def valid(self) -> bool:
        return self._index is not None

    # -- reading -------------------------------------------------------------

    def _load_index(self) -> None:
        try:
            if not os.path.exists(self.path):
                return
            with open(self.path, "rb") as f:
                if f.read(8) != MAGIC:
                    return
                hlen = int.from_bytes(f.read(4), "little")
                header = json.loads(f.read(hlen))
            if header.get("version") != VERSION:
                return
            if header.get("source") != _source_sig(self.gguf_path):
                return
            self._data_base = (8 + 4 + hlen + 63) // 64 * 64
            self._mmap = np.memmap(self.path, dtype=np.uint8, mode="r")
            self._index = header["tensors"]
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            self._mmap = None
            self._index = None

    def get(self, name: str) -> RepackedWeight | None:
        """The entry ``name`` as read-only views into the mapped file, or
        None when it is not there."""
        if self._index is None:
            return None
        rec = self._index.get(name)
        if rec is None:
            return None
        arrays: dict[str, np.ndarray | None] = {}
        for field in _FIELDS:
            meta = rec["arrays"].get(field)
            if meta is None:
                arrays[field] = None
                continue
            off = self._data_base + meta["offset"]  # offsets are data-relative
            buf = self._mmap[off: off + meta["nbytes"]]
            arrays[field] = buf.view(np.dtype(meta["dtype"])).reshape(
                meta["shape"])
        return RepackedWeight(
            packed=arrays["packed"], scales=arrays["scales"],
            mins=arrays["mins"], fmt=rec["fmt"], group=rec["group"],
            k=rec["k"], n=rec["n"], source_type=GGMLType[rec["source_type"]])

    # -- writing -------------------------------------------------------------

    def put(self, name: str, rw: RepackedWeight) -> None:
        """Stage an entry: its bytes go to the temporary data file now, its
        metadata (offsets relative to the data) waits for flush()."""
        if self._index is not None or self._failed:
            return
        try:
            if self._tmp_file is None:
                fd, self._tmp_path = tempfile.mkstemp(
                    dir=os.path.dirname(self.path) or ".",
                    suffix=".repack.tmp")
                self._tmp_file = os.fdopen(fd, "wb")
                self._tmp_file.seek(HEADER_ROOM)
            amet = {}
            for field in _FIELDS:
                arr = getattr(rw, field)
                if arr is None:
                    continue
                arr = np.ascontiguousarray(arr)
                pad = (-self._tmp_pos) % 64
                if pad:
                    self._tmp_file.write(b"\0" * pad)
                    self._tmp_pos += pad
                amet[field] = {
                    "dtype": arr.dtype.str, "shape": list(arr.shape),
                    "offset": self._tmp_pos, "nbytes": int(arr.nbytes),
                }
                self._tmp_file.write(arr.data)
                self._tmp_pos += arr.nbytes
            self._pending[name] = {
                "fmt": rw.fmt, "group": rw.group, "k": rw.k, "n": rw.n,
                "source_type": GGMLType(rw.source_type).name,
                "arrays": amet,
            }
        except OSError:
            # a sidecar missing entries must never be flushed: it would be
            # valid, and those entries repacked at every load
            self._failed = True
            self._discard_tmp()

    def _discard_tmp(self) -> None:
        if self._tmp_file is not None:
            try:
                self._tmp_file.close()
            except OSError:
                pass
            self._tmp_file = None
        if self._tmp_path is not None:
            try:
                os.unlink(self._tmp_path)
            except OSError:
                pass
            self._tmp_path = None
        self._pending.clear()
        self._tmp_pos = 0

    def flush(self) -> None:
        """Write the sidecar: the header into the room before the data (or,
        when it does not fit, ahead of a copy of the data in a second
        temporary file), then rename over the sidecar. Nothing to do when
        the sidecar was valid or nothing was staged."""
        if self._index is not None or self._failed or \
                not self._pending or self._tmp_file is None:
            return
        header = {
            "version": VERSION,
            "source": _source_sig(self.gguf_path),
            "tensors": self._pending,
        }
        hbytes = json.dumps(header).encode()
        out_tmp = None
        try:
            self._tmp_file.close()
            self._tmp_file = None
            if 12 + len(hbytes) <= HEADER_ROOM:
                hbytes += b" " * (HEADER_ROOM - 12 - len(hbytes))
                with open(self._tmp_path, "r+b") as f:
                    f.write(MAGIC + len(hbytes).to_bytes(4, "little")
                            + hbytes)
                os.replace(self._tmp_path, self.path)
                self._tmp_path = None
            else:
                base = 8 + 4 + len(hbytes)
                fd, out_tmp = tempfile.mkstemp(
                    dir=os.path.dirname(self.path) or ".",
                    suffix=".repack.hdr")
                with os.fdopen(fd, "wb") as f:
                    f.write(MAGIC)
                    f.write(len(hbytes).to_bytes(4, "little"))
                    f.write(hbytes)
                    f.write(b"\0" * ((base + 63) // 64 * 64 - base))
                    with open(self._tmp_path, "rb") as data:
                        data.seek(HEADER_ROOM)
                        while chunk := data.read(64 << 20):
                            f.write(chunk)
                os.replace(out_tmp, self.path)
                out_tmp = None
            self._load_index()
        except OSError:
            if out_tmp is not None:
                try:
                    os.unlink(out_tmp)
                except OSError:
                    pass
        finally:
            self._discard_tmp()

    def __del__(self):
        try:
            self._discard_tmp()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


def open_cache(gguf_path: str) -> RepackCache | None:
    """The sidecar of ``gguf_path``; None when LLAMA_GGUF_NO_REPACK_CACHE=1
    or it cannot be opened."""
    if os.environ.get("LLAMA_GGUF_NO_REPACK_CACHE", "0") == "1":
        return None
    try:
        return RepackCache(gguf_path)
    except OSError:
        return None
