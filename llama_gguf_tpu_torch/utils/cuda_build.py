"""Build the port's CUDA sources into shared libraries and load them.

Each source under llama_gguf_tpu_torch/csrc/ is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. Libraries are cached under ``.cache/torch_kernels/`` at the root
of the checkout, keyed by a hash of the source, the shared headers and the
flags, so a process
builds a kernel at its first use only when no earlier process has.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".cache" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_SECONDS: dict[str, float] = {}  # compile time of each source, this process


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """The cached library's path, keyed by the source, the shared headers
    (csrc/*.cuh) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is cached; returns the path."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        BUILD_SECONDS[name] = time.perf_counter() - t0
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(names) -> None:
    """Compile several sources at once, one nvcc process each; raises the
    first build error."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for fut in [pool.submit(build, n) for n in names]:
            fut.result()


def loaded(name: str) -> ctypes.CDLL | None:
    """The library of csrc/<name>.cu if this process has loaded it."""
    return _LIBS.get(name)


def load(name: str, signatures: dict[str, list] | None = None) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use.
    ``signatures`` ({function: argtypes}) are bound when the library is first
    loaded; every function returns an int (a cudaError_t)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in (signatures or {}).items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
