"""The references and the frozen dequantization against the port's plain
CPU path at tiny sizes, and the import rules."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, tiny
from h100bench import ggml, weights


@pytest.mark.parametrize("fmt,shape", [(ggml.Q4_K, (6, 512)),
                                       (ggml.Q6_K, (5, 256)),
                                       (ggml.Q5_1, (7, 96))])
def test_frozen_dequant_equals_the_ports(fmt, shape):
    from llama_gguf_tpu_torch.gguf.constants import GGMLType
    from llama_gguf_tpu_torch.quant.dequant import dequantize as port
    from reference.ggml_blocks import dequantize

    gen = torch.Generator().manual_seed(3)
    raw = ggml.random_blocks(fmt, shape, 0.02, gen, "cpu")
    ours = dequantize(raw, fmt, shape)
    theirs = port(raw.numpy().tobytes(), GGMLType(fmt), shape=shape)
    assert torch.equal(ours, torch.from_numpy(np.asarray(theirs)))
    assert 0.01 < float(ours.std()) < 0.04 and abs(float(ours.mean())) < 0.003


def _gguf(cfg, family, tmp_path, seed=5):
    md, tensors = weights.make(cfg, family, seed, "cpu")
    path = str(tmp_path / "m.gguf")
    ggml.write_gguf(path, md, tensors)
    return path, tensors


@pytest.mark.parametrize("name,family", [("tiny-mixtral", "mixtral"),
                                         ("tiny-moonlight", "deepseek2")])
@pytest.mark.parametrize("mode", ["dequant", "quant"])
def test_reference_equals_the_ports_plain_path(name, family, mode, tmp_path):
    import importlib

    from h100bench.check import reference_model
    from llama_gguf_tpu_torch.engine.engine import EngineConfig, make_runner
    from llama_gguf_tpu_torch.models.loader import load_model

    cfg = tiny(name)
    fam = importlib.import_module(f"reference.{family}")
    path, tensors = _gguf(cfg, fam, tmp_path)
    params, mcfg, _ = load_model(path, mode=mode, device="cpu")
    runner = make_runner(params, mcfg, EngineConfig(max_context_len=256),
                         "cpu")
    ids = np.random.default_rng(1).integers(3, cfg["vocab_size"], 70)
    t = len(ids)
    kv = runner.init_kv(1)
    got, _ = runner.step(ids[None].astype(np.int32),
                         np.arange(t, dtype=np.int32)[None],
                         np.array([t], np.int32), kv)
    ref = reference_model(cfg, tensors, "cpu").logits(ids.tolist(), 0)
    got = got[0].float()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 2e-5 * scale
    assert scale > 0.1


def test_the_tokenizer_decodes_every_allowed_id_to_text(tmp_path):
    from llama_gguf_tpu_torch.tokenizer.gguf_tokenizer import Tokenizer

    tok = Tokenizer.from_gguf(weights.tokenizer_metadata(300))
    for i in (0, 3, 150, 299):
        assert tok.decode([i]) and not tok.is_eog(i)
    assert all(tok.is_eog(i) or not tok.decode([i])
               for i in weights.BANNED)


def test_runs_and_references_load_neither_jax_nor_the_jax_package():
    """One process imports what a run imports (and so does the guard's
    check); another imports only the references, which must not load the
    port either. Names are compared whole before the first dot."""
    from h100bench.guard import loaded

    assert loaded(["llama_gguf_tpu_torch.engine", "jaxlib.xla", "numpy"]) \
        == ["jaxlib"]
    assert loaded(["llama_gguf_tpu.engine"]) == ["llama_gguf_tpu"]
    run = ("import sys; sys.path[:0] = [%r, %r];"
           "import h100bench.bench, h100bench.serve, h100bench.check;"
           "import llama_gguf_tpu_torch.engine.batched,"
           " llama_gguf_tpu_torch.engine.engine,"
           " llama_gguf_tpu_torch.models.loader;"
           "from h100bench.guard import loaded; print(loaded())"
           % (BENCH, ROOT))
    ref = ("import sys; sys.path[:0] = [%r];"
           "import reference.mixtral, reference.deepseek2,"
           " reference.ggml_blocks;"
           "from h100bench.guard import loaded;"
           "print(loaded(forbidden={'jax', 'jaxlib', 'flax',"
           " 'llama_gguf_tpu', 'llama_gguf_tpu_torch'}))" % BENCH)
    env = dict(os.environ)
    for code in (run, ref):
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip().splitlines()[-1] == "[]"
