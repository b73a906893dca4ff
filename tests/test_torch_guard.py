"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, its entry points default to CUDA and raise without it, and
chip_smoke.py refuses to run without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "llama_gguf_tpu_torch"


def _port_modules():
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if parts[-1] != "__main__":
            mods.append(".".join(parts))
    return mods


# importing these fails in the fresh interpreters below: the card's machine
# has neither jax, aiohttp nor requests, and jinja2 may be missing
ABSENT = ("jax", "llama_gguf_tpu", "aiohttp", "requests", "jinja2")


def test_every_module_imports_without_jax():
    """Each module imports in a fresh interpreter where importing jax,
    llama_gguf_tpu, aiohttp, requests or jinja2 fails."""
    mods = _port_modules()
    assert "llama_gguf_tpu_torch.ops.qmatmul" in mods
    assert "llama_gguf_tpu_torch.models.deltanet" in mods
    assert "llama_gguf_tpu_torch.server.app" in mods
    assert "llama_gguf_tpu_torch.client" in mods
    for new in ("engine.perplexity", "engine.prompt_cache", "config",
                "manpages", "hub", "models.mamba", "models.bert",
                "models.t5", "onnx.wire", "onnx.loader", "onnx.export",
                "tokenizer.hf_json", "parallel.sharding", "parallel.service",
                "parallel.multihost", "parallel.follower", "rag",
                "rag.chunking", "rag.multimodal", "rag.hnsw",
                "rag.sqlite_store", "rag.pgvector_store", "rag.embeddings",
                "rag.sync", "rag.knowledge_base", "rag.cli"):
        assert f"llama_gguf_tpu_torch.{new}" in mods
    code = ("import sys\n"
            f"for m in {ABSENT!r}:\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chat_template_falls_back_without_jinja2():
    """Without jinja2, a GGUF's embedded template renders by its vocab
    style (chatml here), as the JAX package does."""
    code = ("import sys\n"
            f"for m in {ABSENT!r}:\n"
            "    sys.modules[m] = None\n"
            "from types import SimpleNamespace\n"
            "from llama_gguf_tpu_torch.engine.chat import ChatTemplate\n"
            "tok = SimpleNamespace(tokens=['<|im_start|>', '<|im_end|>'],\n"
            "                      chat_template='{{ messages }}')\n"
            "t = ChatTemplate.detect(tok)\n"
            "print(t.style, t.render([{'role': 'user', 'content': 'hi'}])"
            "[:19])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "chatml <|im_start|>user\nhi"


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top != "jax", f"{path}: imports {name}"
        assert top != "llama_gguf_tpu", f"{path}: imports {name}"


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from llama_gguf_tpu_torch.engine.engine import Engine
    from llama_gguf_tpu_torch.engine.runner import ModelRunner
    from llama_gguf_tpu_torch.gguf.constants import GGMLType
    from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

    path = build_synthetic_gguf(str(tmp_path / "m.gguf"), preset="tiny",
                                quant=GGMLType.Q8_0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine.load(path)  # default device is CUDA: no silent CPU fallback
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRunner({}, None)
    from llama_gguf_tpu_torch import cli

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", path, "-p", "hi", "-n", "2"])


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card chip_smoke.py exits non-zero and prints no result;
    alone in a directory (no port beside it) it fails too."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=240, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240,
                         env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_kernel_wrappers_refuse_other_devices():
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.ops.linear import QuantLinear

    lin = QuantLinear(torch.zeros(16, 8, dtype=torch.uint8),
                      torch.zeros(1, 8), None, None, "q4", 32, 32, 8)
    x = torch.zeros(1, 32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        Q.qmatmul(x, lin)


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::qgemm_splitk<0, true, float, float, 0>"
     "(const float *, ...)", "qmatmul_q4 split-K"),
    ("void (anonymous namespace)::qgemm_tc<1, 2, float, float, 0>(...)",
     "qmatmul_q8 tensor cores"),
    ("void (anonymous namespace)::qgemm_splitk<0, true, float, float, 1>(...)",
     "qmatmul_glu split-K"),
    ("void (anonymous namespace)::qgemm_splitk<1, true, float, bf16, 4>(...)",
     "moe_slot split-K"),
    ("void (anonymous namespace)::qgemm_tc<1, 2, float, float, 2>(...)",
     "moe_grouped tensor cores"),
    ("void (anonymous namespace)::qgemm_tc<0, 2, float, float, 3>(...)",
     "moe_glu_grouped tensor cores"),
    ("void (anonymous namespace)::moe_grouped_kernel<0, 2, true, float>(...)",
     "moe_grouped_kernel"),
])
def test_chip_smoke_profile_keys_name_each_kind(name, want):
    """The decode profiles key csrc/qgemm.cu's launches by the kind, the last
    template argument (bit flags GLU 1, GATHERED 2, SLOT 4), and the path."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.kernel_key(name) == want


def test_hf_json_without_regex(tmp_path):
    """The card's machine may lack the regex package: the tokenizer.json
    reader then compiles Split patterns with re, and a Unigram file still
    round-trips."""
    import json

    from llama_gguf_tpu_torch.onnx.export import unigram_tokenizer_json

    tj = unigram_tokenizer_json(128)
    tj["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": "[0-9]+"},
         "behavior": "Isolated"}, tj["pre_tokenizer"]]}
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(tj))
    code = ("import sys\n"
            "sys.modules['regex'] = None\n"
            "from llama_gguf_tpu_torch.tokenizer.hf_json import HFTokenizer\n"
            f"t = HFTokenizer({str(path)!r})\n"
            "ids = t.encode('hello 42 world', add_special=False)\n"
            "print(len(ids) > 3, t.decode(ids))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[0].startswith("True")
