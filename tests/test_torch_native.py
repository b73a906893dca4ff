"""The port's native load-path library (llama_gguf_tpu_torch/native) on the
CPU. For each of its nine formats: the native dequant is bit-equal to the
port's numpy version and to the JAX package's quant/dequant.dequantize, and
the native ``_extract`` (levels, scales, mins) to the numpy one, on seeded
quantized blocks (finite f16 scales) and on seeded raw bytes (every f16
pattern: infinities and NaNs too, where a NaN must meet a NaN; the payload
of a NaN is not compared). Then the dispatch and its counters, a build that
fails (it raises with the compiler's message, and so does every later
bulk call), and LLAMA_GGUF_NO_NATIVE=1, which selects numpy for both."""

import numpy as np
import pytest

from llama_gguf_tpu.quant import dequant as jdequant

from llama_gguf_tpu_torch import native
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.quant import dequant as DQ
from llama_gguf_tpu_torch.quant import repack as R
from llama_gguf_tpu_torch.quant.quantize import quantize

FORMATS = sorted(native.NATIVE_FORMATS)
N, K = 256, 512  # every format's bytes reach the 64 KiB bulk threshold


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("LLAMA_GGUF_NO_NATIVE", raising=False)


def quantized(fmt, seed=0):
    x = np.random.default_rng(seed).standard_normal((N, K)).astype(
        np.float32) * 0.1
    return np.frombuffer(quantize(x, GGMLType[fmt]), np.uint8)


def raw_bytes(fmt, seed=1):
    _, _, block_bytes, block_elems, _, _ = native.NATIVE_FORMATS[fmt]
    return np.random.default_rng(seed).integers(
        0, 256, size=N * K // block_elems * block_bytes, dtype=np.uint8)


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def same_or_both_nan(a, b):
    nan = np.isnan(a)
    return (np.array_equal(nan, np.isnan(b))
            and bits_equal(a[~nan], b[~nan]))


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequant_bit_equal_on_quantized_blocks(fmt):
    raw = quantized(fmt)
    assert raw.nbytes >= DQ.BULK_BYTES
    got = native.dequantize_native(raw, fmt)
    assert got.shape == (N * K,)
    assert bits_equal(got, DQ._DEQUANT[GGMLType[fmt]](raw))
    assert bits_equal(got, np.asarray(jdequant.dequantize(raw,
                                                          GGMLType[fmt])))
    assert bits_equal(DQ.dequantize(raw, GGMLType[fmt], shape=(N, K)),
                      got.reshape(N, K))


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequant_equal_on_raw_bytes(fmt):
    raw = raw_bytes(fmt)
    got = native.dequantize_native(raw, fmt)
    with np.errstate(all="ignore"):
        want = DQ._DEQUANT[GGMLType[fmt]](raw)
        want_jax = np.asarray(jdequant.dequantize(raw, GGMLType[fmt]))
    assert same_or_both_nan(got, want)
    assert same_or_both_nan(got, want_jax)


@pytest.mark.parametrize("source", ["quantized", "raw bytes"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_extract_bit_equal(fmt, source):
    raw = quantized(fmt) if source == "quantized" else raw_bytes(fmt)
    t = GGMLType[fmt]
    got = R._extract(raw, t, N, K)
    with np.errstate(all="ignore"):
        want = R._extract_numpy(raw, t, N, K)
    assert got[3:] == want[3:]  # layout, group
    for g, w in zip(got[:3], want[:3]):
        assert (g is None) == (w is None)
        if g is not None:
            assert bits_equal(g, np.ascontiguousarray(w))


def test_counters_count_bulk_calls():
    native.reset_counts()
    raw = quantized("Q6_K")
    DQ.dequantize(raw, GGMLType.Q6_K)
    DQ.dequantize(raw[:210 * 8], GGMLType.Q6_K)  # small: not a bulk call
    R.repack(quantized("Q4_K"), GGMLType.Q4_K, (N, K))
    R.repack(quantize(np.ones((8, 256), np.float32), GGMLType.Q2_K),
             GGMLType.Q2_K, (8, 256))  # not a native format: not counted
    assert native.COUNTS["native"] == {"dequant Q6_K": 1, "extract Q4_K": 1}
    assert not native.COUNTS["numpy"]


def test_switch_selects_numpy(monkeypatch):
    """LLAMA_GGUF_NO_NATIVE=1 (the JAX package's switch) gives the numpy
    versions of the dequant and the extraction, the same values, counted as
    numpy."""
    raw_q6, raw_q4 = quantized("Q6_K"), quantized("Q4_K")
    want_deq = DQ.dequantize(raw_q6, GGMLType.Q6_K)
    want_rw = R.repack(raw_q4, GGMLType.Q4_K, (N, K))
    monkeypatch.setenv("LLAMA_GGUF_NO_NATIVE", "1")
    native.reset_counts()
    assert native.load_library() is None and not native.available()
    assert native.dequantize_native(raw_q6, "Q6_K") is None
    assert bits_equal(DQ.dequantize(raw_q6, GGMLType.Q6_K), want_deq)
    rw = R.repack(raw_q4, GGMLType.Q4_K, (N, K))
    for field in ("packed", "scales", "mins"):
        assert bits_equal(getattr(rw, field), getattr(want_rw, field))
    assert native.COUNTS["numpy"] == {"dequant Q6_K": 1, "extract Q4_K": 1}
    assert not native.COUNTS["native"]


def test_failed_build_raises_with_the_compiler_message(monkeypatch, tmp_path):
    """No quiet fallback: a source the compiler refuses raises
    NativeBuildError naming the compiler's error, at the first bulk call
    and at every later one, until LLAMA_GGUF_NO_NATIVE selects numpy."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" void dequant_q4_0( { this is not C++ }\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    raw = quantized("Q4_0")
    for _ in range(2):
        with pytest.raises(native.NativeBuildError) as err:
            DQ.dequantize(raw, GGMLType.Q4_0)
        assert "error" in str(err.value) and "broken.cpp" in str(err.value)
        assert "LLAMA_GGUF_NO_NATIVE" in str(err.value)
    with pytest.raises(native.NativeBuildError):
        R.repack(raw, GGMLType.Q4_0, (N, K))
    assert not any((tmp_path / "build").iterdir())  # no partial library
    monkeypatch.setenv("LLAMA_GGUF_NO_NATIVE", "1")
    assert bits_equal(DQ.dequantize(raw, GGMLType.Q4_0),
                      DQ.dequantize_q4_0(raw))


def test_library_is_keyed_by_source_and_flags(monkeypatch, tmp_path):
    """A changed source or flag set is another library file."""
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.endswith(".so")
    src = tmp_path / "dequant.cpp"
    src.write_bytes(native.SRC.read_bytes() + b"\n// changed\n")
    monkeypatch.setattr(native, "SRC", src)
    assert native.library_path() != path
    monkeypatch.setattr(native, "FLAGS", (("-O2",),))
    assert native.library_path() != path


def test_buffer_converters():
    rng = np.random.default_rng(3)
    h = rng.standard_normal(1000).astype(np.float16)
    assert bits_equal(native.f16_to_f32(h.view(np.uint8)),
                      h.astype(np.float32))
    b = rng.integers(0, 1 << 16, size=1000, dtype=np.uint16)
    want = (b.astype(np.uint32) << 16).view(np.float32)
    assert bits_equal(native.bf16_to_f32(b.view(np.uint8)), want)


@pytest.mark.parametrize("shape", [(64, 64), (100, 37), (3000, 257)])
def test_transpose_equals_numpy(monkeypatch, shape):
    """The repack's transpose of one-byte levels, native (64 x 64 tiles,
    ragged edges) and under LLAMA_GGUF_NO_NATIVE, equals numpy's."""
    a = np.random.default_rng(4).integers(-128, 128, size=shape,
                                          dtype=np.int8)
    got = R._transpose(a)
    assert bits_equal(got, np.ascontiguousarray(a.T))
    monkeypatch.setenv("LLAMA_GGUF_NO_NATIVE", "1")
    assert native.transpose_bytes(a) is None
    assert bits_equal(R._transpose(a), got)


def test_counts_survive_threads():
    """record() from more threads than cores, the switch interval
    shortened: no increment is lost."""
    import sys
    import threading

    native.reset_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [native.record("dequant", "Q4_K", True)
                            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert native.COUNTS["native"]["dequant Q4_K"] == 16 * 2000


def test_concurrent_builds(tmp_path):
    """Processes building the library into one empty directory at once all
    load it, and leave one library and no temporary file behind."""
    import subprocess
    import sys

    code = ("import sys, pathlib\n"
            "from llama_gguf_tpu_torch import native\n"
            "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "print(native.available())\n")
    root = str(native.SRC.parents[3])
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert all(out.strip() == "True" for out, _ in outs)
    assert [f.name for f in tmp_path.iterdir()] == [
        native.library_path().name]
