"""Native (C++) host kernels of the load path, built at first use.

A copy of llama_gguf_tpu/native (the port never imports the JAX package)
with the repack's bit plumbing added: ``src/dequant.cpp`` holds, for the
nine formats of NATIVE_FORMATS, the bulk block dequantization that
quant/dequant.dequantize routes data from 64 KiB through, and the
extraction of integer levels, scales and mins that quant/repack._extract
routes every tensor through, both bit-equal to the numpy versions, and the
repack's transpose of one-byte levels.

The library is compiled with g++ (-O3 -march=native -fopenmp
-ffp-contract=off; without -march and OpenMP as the retry) at its first
use, never at import, into ``.cache/native/`` at the root of the checkout,
keyed by a hash of the source, the flags, the compiler and the host CPU;
the build writes a temporary file and renames it, so concurrent processes
never load half a library. It is loaded with ctypes, which releases the
GIL during each call.

Unlike the JAX package, a failed build or load raises, with the compiler's
message. ``LLAMA_GGUF_NO_NATIVE=1`` (the JAX package's switch) selects the
numpy versions explicitly, for the dequant and the extraction alike.
``COUNTS`` counts the bulk calls each served, by operation and format.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from collections import Counter
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "dequant.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".cache" / "native"
CXX = "g++"
# the first command line, then the retry without -march=native and OpenMP
FLAGS = (("-O3", "-march=native", "-ffp-contract=off", "-fopenmp"),
         ("-O3", "-ffp-contract=off"))

# format: (dequant function, extract function, block bytes, block elements,
# elements per scale group, layout of the levels)
NATIVE_FORMATS = {
    "Q4_0": ("dequant_q4_0", "extract_q4_0", 18, 32, 32, "q4"),
    "Q4_1": ("dequant_q4_1", "extract_q4_1", 20, 32, 32, "q4"),
    "Q5_0": ("dequant_q5_0", "extract_q5_0", 22, 32, 32, "q8"),
    "Q5_1": ("dequant_q5_1", "extract_q5_1", 24, 32, 32, "q8"),
    "Q8_0": ("dequant_q8_0", "extract_q8_0", 34, 32, 32, "q8"),
    "Q4_K": ("dequant_q4_k", "extract_q4_k", 144, 256, 32, "q4"),
    "Q5_K": ("dequant_q5_k", "extract_q5_k", 176, 256, 32, "q8"),
    "Q6_K": ("dequant_q6_k", "extract_q6_k", 210, 256, 16, "q8"),
    "Q8_K": ("dequant_q8_k", "extract_q8_k", 292, 256, 256, "q8"),
}
# the formats with a min panel
_WITH_MINS = {"Q4_0", "Q4_1", "Q5_1", "Q4_K", "Q5_K"}

# bulk calls served, as {"native" | "numpy": Counter({"dequant Q6_K": n})}
COUNTS = {"native": Counter(), "numpy": Counter()}
_COUNTS_LOCK = threading.Lock()  # loads run on several threads at once

_LOCK = threading.Lock()
_LIB = None
_ERROR: str | None = None


class NativeBuildError(RuntimeError):
    """The native library did not build or load."""


def disabled() -> bool:
    """True when LLAMA_GGUF_NO_NATIVE selects the numpy versions."""
    return bool(os.environ.get("LLAMA_GGUF_NO_NATIVE"))


def record(op: str, fmt: str, native: bool) -> None:
    """Count one bulk call of ``op`` ("dequant", "extract") on ``fmt``."""
    with _COUNTS_LOCK:
        COUNTS["native" if native else "numpy"][f"{op} {fmt}"] += 1


def reset_counts() -> None:
    with _COUNTS_LOCK:
        for c in COUNTS.values():
            c.clear()


def _host_key() -> bytes:
    """What -march=native compiles for: the compiler and the host CPU, so a
    library built on one machine is never loaded on another."""
    try:
        version = subprocess.run([CXX, "--version"], capture_output=True,
                                 timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        version = b""
    cpu = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            cpu = b"".join(sorted({ln for ln in f if ln.startswith(
                (b"model name", b"flags"))}))
    except OSError:
        pass
    return version + cpu + platform.machine().encode()


def library_path() -> Path:
    """The cached library's path, keyed by the source, the flags, the
    compiler and the host CPU."""
    key = SRC.read_bytes() + repr(FLAGS).encode() + _host_key()
    return BUILD_DIR / f"libnative-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile SRC into ``out`` (first command line, then the retry);
    raises NativeBuildError with each attempt's message."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    for flags in FLAGS:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [CXX, *flags, "-shared", "-fPIC", str(SRC), "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
            if res.returncode == 0:
                os.replace(tmp, out)  # atomic: no reader sees half a file
                return
            errors.append(f"$ {' '.join(cmd)}\n{res.stderr.strip()}")
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"$ {' '.join(cmd)}\n{e}")
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    raise NativeBuildError(
        "the native load-path library did not build (set "
        "LLAMA_GGUF_NO_NATIVE=1 to use the numpy versions):\n"
        + "\n".join(errors))


def load_library():
    """The ctypes library, built on first use; None when
    LLAMA_GGUF_NO_NATIVE is set. A failed build or load raises
    NativeBuildError (again at every later call)."""
    global _LIB, _ERROR
    if disabled():
        return None
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _ERROR is not None:
            raise NativeBuildError(_ERROR)
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except NativeBuildError as e:
            _ERROR = str(e)
            raise
        except OSError as e:
            _ERROR = f"the native load-path library did not load: {e}"
            raise NativeBuildError(_ERROR) from e
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        for deq, ext, *_ in NATIVE_FORMATS.values():
            getattr(lib, deq).argtypes = [u8p, f32p, ctypes.c_int64]
            getattr(lib, deq).restype = None
            getattr(lib, ext).argtypes = [u8p, ctypes.c_void_p, f32p, f32p,
                                          ctypes.c_int64]
            getattr(lib, ext).restype = None
        lib.transpose_u8.argtypes = [u8p, u8p, ctypes.c_int64,
                                     ctypes.c_int64]
        lib.transpose_u8.restype = None
        for fn in ("f16_to_f32_buf", "bf16_to_f32_buf"):
            getattr(lib, fn).argtypes = [u8p, f32p, ctypes.c_int64]
            getattr(lib, fn).restype = None
        lib.native_num_threads.restype = ctypes.c_int
        _LIB = lib
        return lib


def available() -> bool:
    """True when the native versions serve (the switch is not set and the
    library builds); a failed build raises."""
    return load_library() is not None


def _bytes(raw) -> np.ndarray:
    """Raw bytes (an array's, whatever its dtype, or a buffer's) as a
    contiguous uint8 vector."""
    if isinstance(raw, np.ndarray):
        return np.ascontiguousarray(raw).reshape(-1).view(np.uint8)
    return np.frombuffer(raw, np.uint8)


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def dequantize_native(raw, type_name: str) -> np.ndarray | None:
    """Dequantize raw block bytes with the native kernel to f32 [elements];
    None when the format is not native, the bytes are not whole blocks, or
    LLAMA_GGUF_NO_NATIVE is set."""
    spec = NATIVE_FORMATS.get(type_name)
    if spec is None or disabled():
        return None
    lib = load_library()
    fn, _, block_bytes, block_elems, _, _ = spec
    arr = _bytes(raw)
    if arr.nbytes % block_bytes:
        return None
    nblocks = arr.nbytes // block_bytes
    out = np.empty(nblocks * block_elems, np.float32)
    getattr(lib, fn)(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                     _f32p(out), ctypes.c_int64(nblocks))
    return out


def extract_native(raw, type_name: str, n: int, k: int):
    """quant/repack._extract with the native kernel: (q [N, K] uint8 levels
    (q4 layout) or int8 (q8), scales [N, K/g] f32, mins [N, K/g] f32 or None,
    layout, g), bit-equal to the numpy version; None when the format is not
    native or LLAMA_GGUF_NO_NATIVE is set."""
    spec = NATIVE_FORMATS.get(type_name)
    if spec is None or disabled():
        return None
    lib = load_library()
    _, fn, block_bytes, block_elems, group, fmt = spec
    arr = _bytes(raw)
    nblocks = n * k // block_elems
    if k % block_elems or arr.nbytes != nblocks * block_bytes:
        raise ValueError(f"{type_name}: {arr.nbytes} bytes are not "
                         f"[{n}, {k}] in blocks of {block_elems}")
    q = np.empty((n, k), np.uint8 if fmt == "q4" else np.int8)
    scales = np.empty((n, k // group), np.float32)
    mins = (np.empty((n, k // group), np.float32)
            if type_name in _WITH_MINS else None)
    getattr(lib, fn)(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                     q.ctypes.data_as(ctypes.c_void_p), _f32p(scales),
                     _f32p(mins) if mins is not None else None,
                     ctypes.c_int64(nblocks))
    return q, scales, mins, fmt, group


def transpose_bytes(a: np.ndarray) -> np.ndarray | None:
    """A 2-D array of one-byte items as its contiguous transpose, natively;
    None when LLAMA_GGUF_NO_NATIVE is set."""
    if a.ndim != 2 or a.itemsize != 1:
        raise ValueError(f"transpose_bytes: a 2-D array of one-byte items, "
                         f"not {a.dtype} {a.shape}")
    if disabled():
        return None
    lib = load_library()
    a = np.ascontiguousarray(a)
    n, m = a.shape
    out = np.empty((m, n), a.dtype)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.transpose_u8(a.ctypes.data_as(u8p), out.ctypes.data_as(u8p),
                     ctypes.c_int64(n), ctypes.c_int64(m))
    return out


def f16_to_f32(raw) -> np.ndarray:
    """Little-endian f16 bytes as f32, natively (numpy under the switch)."""
    arr = _bytes(raw)
    lib = load_library()
    if lib is None:
        return arr.view("<f2").astype(np.float32)
    out = np.empty(arr.nbytes // 2, np.float32)
    lib.f16_to_f32_buf(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       _f32p(out), ctypes.c_int64(out.size))
    return out


def bf16_to_f32(raw) -> np.ndarray:
    """Little-endian bf16 bytes as f32, natively (numpy under the switch)."""
    arr = _bytes(raw)
    lib = load_library()
    if lib is None:
        return (arr.view("<u2").astype(np.uint32) << 16).view(np.float32)
    out = np.empty(arr.nbytes // 2, np.float32)
    lib.bf16_to_f32_buf(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        _f32p(out), ctypes.c_int64(out.size))
    return out
