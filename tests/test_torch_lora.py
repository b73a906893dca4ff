"""The port's LoRA adapters (models/lora.py, ops/linear.LoraLinear) against
the JAX package's on the CPU.

Adapters are written here in llama.cpp's layout (lora_a [r, K], lora_b
[N, r], F32) onto the JAX speculative tests' tiny qwen2 (F32: 4 layers,
hidden 64, ffn 128, seed 11; Q4_K, whose rows must be 256 wide: 2 layers,
hidden 256, ffn 512), whose loader fuses q|k|v and gate|up in both
packages; adapters on q, k, v, gate and up split them. Compared: the loaded
adapter, the attach and detach counts, and the logits of a prefill and 7
decode steps with the adapter attached, within 1e-5 of max |logit| of the
JAX engine's (F32 and Q4_K weights, dequant and quant modes; the quant
mode's products are the kernels' plain versions here), with greedy tokens
equal. Also the zero-B adapter, the shape mismatch, EngineConfig.lora, the
server and the CLI with an adapter, and the graph reset a rewrite calls.
"""

import numpy as np
import pytest
import torch

from fixtures import make_tiny_model
from llama_gguf_tpu import cli as jcli
from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JEngineConfig
from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.models import lora as jlora

from llama_gguf_tpu_torch import cli
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.runner import ModelRunner
from llama_gguf_tpu_torch.gguf.writer import GGUFWriter
from llama_gguf_tpu_torch.models import lora as tlora
from llama_gguf_tpu_torch.ops.linear import LoraLinear

torch.set_num_threads(1)

REL = 1e-5
MODELS = {"F32": (64, 128, 4), "Q4_K": (256, 512, 2)}  # hidden, ffn, layers
HIDDEN, FFN, LAYERS = MODELS["F32"]
ALL = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up",
       "ffn_down")
IDS = [5, 17, 33, 2, 9, 40, 41, 7]


def shapes_of(hidden, ffn, *_):
    """(K, N) of each adapted projection (4 heads, 2 KV heads, vocab 288)."""
    kv = hidden // 2
    return {"attn_q": (hidden, hidden), "attn_k": (hidden, kv),
            "attn_v": (hidden, kv), "attn_output": (hidden, hidden),
            "ffn_gate": (hidden, ffn), "ffn_up": (hidden, ffn),
            "ffn_down": (ffn, hidden), "output": (hidden, 288)}


SHAPES = shapes_of(*MODELS["F32"])


def write_lora(path, rank=4, alpha=8.0, seed=1, targets=ALL, zero_b=False,
               layers=LAYERS, shapes=SHAPES, head=False, drop=()):
    """An adapter GGUF in llama.cpp's layout; ``drop``: base names written
    with their lora_a only."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter()
    w.add_metadata("general.type", "adapter")
    w.add_metadata("adapter.type", "lora")
    w.add_metadata("adapter.lora.alpha", float(alpha))
    names = [(f"blk.{i}.{t}", t) for i in range(layers) for t in targets]
    names += [("output", "output")] if head else []
    for name, t in names:
        k, n = shapes[t]
        a = rng.normal(size=(rank, k)).astype(np.float32) * 0.1
        b = (np.zeros((n, rank), np.float32) if zero_b else
             rng.normal(size=(n, rank)).astype(np.float32) * 0.1)
        w.add_tensor_np(f"{name}.weight.lora_a", a)
        if name not in drop:
            w.add_tensor_np(f"{name}.weight.lora_b", b)
    w.write_to_path(path)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora")
    out = {}
    for q in (GGMLType.F32, GGMLType.Q4_K):
        hidden, ffn, layers = MODELS[q.name]
        out[q.name] = str(d / f"tiny-{q.name}.gguf")
        make_tiny_model(out[q.name], arch="qwen2", vocab=288, hidden=hidden,
                        layers=layers, heads=4, kv_heads=2, ffn=ffn,
                        ctx=160, seed=11, tokenizer=True, quant=q)
        out[f"adapter-{q.name}"] = write_lora(
            str(d / f"adapter-{q.name}.gguf"), alpha=32.0, seed=3,
            head=True, layers=layers, shapes=shapes_of(hidden, ffn))
    out["adapter"] = out["adapter-F32"]
    out["zero"] = write_lora(str(d / "zero.gguf"), zero_b=True, seed=2,
                             layers=MODELS["Q4_K"][2],
                             shapes=shapes_of(*MODELS["Q4_K"]))
    return out


def logits_of(runner, steps=8):
    """The prefill's and steps - 1 greedy decode steps' logits [steps, V]
    and the tokens, on the runner's own cache."""
    logits, kv, pos = runner.prefill(IDS, runner.init_kv())
    rows, toks = [], []
    for i in range(steps):
        rows.append(np.asarray(logits, np.float32))
        toks.append(int(np.argmax(rows[-1])))
        if i + 1 < steps:
            logits, kv = runner.decode_one(toks[-1], pos, kv)
            pos += 1
    return np.stack(rows), toks


def close(got, want, rel=REL):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{err:.3g} over {rel} of max"


def test_load_gguf_matches_jax(tmp_path, files):
    ad = tlora.LoraAdapter.load_gguf(files["adapter"])
    jad = jlora.LoraAdapter.load_gguf(files["adapter"])
    assert (ad.rank, ad.alpha, ad.scale) == (jad.rank, jad.alpha, jad.scale) \
        == (4, 32.0, 8.0)
    assert ad.tensors.keys() == jad.tensors.keys()
    assert len(ad.tensors) == 7 * LAYERS + 1
    for name, (a, b) in ad.tensors.items():
        np.testing.assert_array_equal(a, jad.tensors[name][0])
        np.testing.assert_array_equal(b, jad.tensors[name][1])
    a, b = ad.tensors["blk.0.ffn_down"]
    assert a.shape == (FFN, 4) and b.shape == (4, HIDDEN)
    assert a.dtype == b.dtype == np.float32 and a.flags.c_contiguous
    # a pair without its lora_b is skipped; none left is an error
    p = write_lora(str(tmp_path / "part.gguf"), layers=1,
                   targets=("attn_q", "attn_k"), drop=("blk.0.attn_k",))
    assert list(tlora.LoraAdapter.load_gguf(p).tensors) == \
        list(jlora.LoraAdapter.load_gguf(p).tensors) == ["blk.0.attn_q"]
    p = write_lora(str(tmp_path / "none.gguf"), layers=1,
                   targets=("attn_q",), drop=("blk.0.attn_q",))
    with pytest.raises(ValueError, match="no lora_a/lora_b"):
        tlora.LoraAdapter.load_gguf(p)
    w = GGUFWriter()
    w.add_metadata("general.type", "model")
    w.add_tensor_np("x", np.zeros((4, 4), np.float32))
    w.write_to_path(str(tmp_path / "model.gguf"))
    for mod in (tlora, jlora):
        with pytest.raises(ValueError, match="not a LoRA adapter"):
            mod.LoraAdapter.load_gguf(str(tmp_path / "model.gguf"))


@pytest.mark.parametrize("quant,mode", [("F32", "dequant"),
                                        ("Q4_K", "dequant"),
                                        ("Q4_K", "quant")])
def test_logits_with_adapter_match_jax(files, quant, mode):
    jt = JEngine.load(files[quant], JEngineConfig(weight_mode=mode))
    tt = Engine.load(files[quant], EngineConfig(weight_mode=mode),
                     device="cpu")
    base, base_toks = logits_of(tt.runner)
    layer = tt.runner.params["layers"][0]
    assert "wqkv" in layer["attn"] and "gate_up" in layer["ffn"]
    ad = tlora.LoraAdapter.load_gguf(files[f"adapter-{quant}"])
    jad = jlora.LoraAdapter.load_gguf(files[f"adapter-{quant}"])
    n = tlora.apply_lora(tt.runner.params, ad, runner=tt.runner)
    assert n == jlora.apply_lora(jt.runner.params, jad) == \
        7 * MODELS[quant][2] + 1
    jt.runner._steps.clear()  # the JAX step retraces on the new tree
    # the fused projections were split, each slice contiguous
    assert "wqkv" not in layer["attn"] and "gate_up" not in layer["ffn"]
    for key in ("wq", "wk", "wv"):
        lin = layer["attn"][key]
        assert isinstance(lin, LoraLinear) and lin.base.splits is None
        for t in vars(lin.base).values():
            assert not torch.is_tensor(t) or t.is_contiguous()
    want, want_toks = logits_of(jt.runner)
    got, toks = logits_of(tt.runner)
    close(got, want)
    assert toks == want_toks
    assert np.abs(got - base).max() > 1e-2 * np.abs(base).max()
    # a second attach replaces the first; the scale can be overridden
    assert tlora.apply_lora(tt.runner.params, ad, scale=0.0) == n
    assert isinstance(layer["attn"]["wq"].base, type(layer["attn"]["wo"]
                                                     .base))
    close(logits_of(tt.runner)[0], base, 1e-5)
    assert tlora.remove_lora(tt.runner.params) == \
        jlora.remove_lora(jt.runner.params) == n
    assert tlora.remove_lora(tt.runner.params) == 0
    # the split base stays split, as in the JAX package
    assert "wq" in layer["attn"] and "gate" in layer["ffn"]
    close(logits_of(tt.runner)[0], base, 1e-5)


def test_zero_b_adapter_is_identity(files):
    tt = Engine.load(files["Q4_K"], EngineConfig(weight_mode="quant"),
                     device="cpu")
    before = tt.greedy_tokens(IDS, 8)
    base, _ = logits_of(tt.runner)
    assert tlora.apply_lora(tt.runner.params, tlora.LoraAdapter.load_gguf(
        files["zero"]), runner=tt.runner) == 7 * MODELS["Q4_K"][2]
    assert tt.greedy_tokens(IDS, 8) == before
    close(logits_of(tt.runner)[0], base, 1e-6)


def test_shape_mismatch_rejected(tmp_path, files):
    tt = Engine.load(files["F32"], EngineConfig(weight_mode="dequant"),
                     device="cpu")
    p = write_lora(str(tmp_path / "bad.gguf"), layers=1,
                   targets=("attn_q",), shapes={"attn_q": (32, 32)})
    calls = []
    tt.runner.reset_graphs = lambda: calls.append(1)
    with pytest.raises(ValueError, match="shape mismatch"):
        tlora.apply_lora(tt.runner.params, tlora.LoraAdapter.load_gguf(p),
                         runner=tt.runner)
    assert calls == [1]  # graphs dropped even though the attach failed


def test_experts_and_tied_head_skipped(tmp_path, caplog):
    """No param mapping for expert stacks, and no head linear in a tied
    model: those adapter tensors are skipped with JAX's warnings."""
    from llama_gguf_tpu.utils.synthetic import build_synthetic_gguf

    path = str(tmp_path / "moe.gguf")
    build_synthetic_gguf(path, preset="tiny-moe", quant=GGMLType.F32)
    tt = Engine.load(path, EngineConfig(weight_mode="dequant"),
                     device="cpu")
    jt = JEngine.load(path, JEngineConfig(weight_mode="dequant"))
    p = write_lora(str(tmp_path / "moe-lora.gguf"), layers=2,
                   targets=("attn_q", "ffn_gate"),
                   shapes={"attn_q": (128, 128), "ffn_gate": (128, 256)})
    w = GGUFWriter()  # plus an expert-stack pair
    w.add_metadata("general.type", "adapter")
    w.add_tensor_np("blk.0.ffn_gate_exps.weight.lora_a",
                    np.ones((2, 128), np.float32))
    w.add_tensor_np("blk.0.ffn_gate_exps.weight.lora_b",
                    np.ones((256, 2), np.float32))
    w.write_to_path(str(tmp_path / "exps.gguf"))
    for f in (p, str(tmp_path / "exps.gguf")):
        caplog.clear()
        n = tlora.apply_lora(tt.runner.params, tlora.LoraAdapter.load_gguf(f))
        assert n == jlora.apply_lora(jt.runner.params,
                                     jlora.LoraAdapter.load_gguf(f))
        assert "skipped" in caplog.text
    assert n == 0


def test_engine_config_lora(files):
    want_eng = JEngine.load(files["F32"], JEngineConfig(
        weight_mode="dequant", lora=files["adapter"]))
    eng = Engine.load(files["F32"], EngineConfig(
        weight_mode="dequant", lora=files["adapter"]), device="cpu")
    plain = Engine.load(files["F32"], EngineConfig(weight_mode="dequant"),
                        device="cpu")
    got = eng.greedy_tokens(IDS, 8)
    assert got == want_eng.greedy_tokens(IDS, 8)
    assert got != plain.greedy_tokens(IDS, 8)
    assert isinstance(eng.runner.params["output"], LoraLinear)
    # lora_scale overrides alpha / r: scale 0 is the base model
    zero = Engine.load(files["F32"], EngineConfig(
        weight_mode="dequant", lora=files["adapter"], lora_scale=0.0),
        device="cpu")
    assert zero.greedy_tokens(IDS, 8) == plain.greedy_tokens(IDS, 8)


def test_cli_run_with_adapter_matches_jax(files, capsys, tmp_path):
    argv = ["run", files["F32"], "--lora", files["adapter"], "-p",
            "tok1 tok2 tok3", "-n", "8", "-t", "0", "--weight-mode",
            "dequant"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert got == capsys.readouterr().out
    # the TOML's [model].lora, and --lora-scale
    cfg = tmp_path / "c.toml"
    cfg.write_text(f'[model]\nlora = "{files["adapter"]}"\n')
    args = cli.build_parser().parse_args(
        ["run", files["F32"], "--config", str(cfg), "--lora-scale", "0.5"])
    ec = cli._engine_config(cli._load_config(args), args)
    assert (ec.lora, ec.lora_scale) == (files["adapter"], 0.5)
    sc = cli.serve_config(cli.build_parser().parse_args(
        ["serve", files["F32"], "--config", str(cfg)]))
    assert sc.lora == files["adapter"]


class StubRunner:
    """Records the graph resets a params rewrite asks for."""

    def __init__(self):
        self.resets = 0

    def reset_graphs(self):
        self.resets += 1


def test_rewrites_reset_the_graphs(files):
    tt = Engine.load(files["F32"], EngineConfig(weight_mode="dequant"),
                     device="cpu")
    ad = tlora.LoraAdapter.load_gguf(files["adapter"])
    stub = StubRunner()
    tlora.apply_lora(tt.runner.params, ad, runner=stub)
    assert stub.resets == 1
    tlora.remove_lora(tt.runner.params, runner=stub)
    assert stub.resets == 2
    # the runner's reset drops every graph, the greedy buffers and the pool
    r = tt.runner
    r._graphs[(1, 8, 256, False)] = object()
    r._greedy_io[(1, None)] = (torch.zeros(1), torch.zeros(1))
    r._pool = object()
    kv = r.init_kv()
    r.reset_graphs()
    assert not r._graphs and not r._greedy_io and r._pool is None
    assert r.init_kv() is kv  # the caches stay


def test_rewrite_resets_the_self_drafts_graphs(files):
    """The self-draft's layers are the target's own dicts, so a rewrite
    through either runner drops the graphs of both (a kept graph would
    replay the freed fused wqkv and gate_up); a runner over other params
    keeps its graphs."""
    import gc

    from llama_gguf_tpu_torch.engine import speculative as tspec

    tt, other = (Engine.load(files["F32"], EngineConfig(
        weight_mode="dequant"), device="cpu") for _ in range(2))
    target = tt.runner
    draft = tspec.make_self_draft(target, 1)
    ad = tlora.LoraAdapter.load_gguf(files["adapter"])

    def fill(r):
        r._graphs[(1, 8, 256, False)] = object()
        r._greedy_io[(1, None)] = (torch.zeros(1), torch.zeros(1))
        r._pool = object()

    for via, rewrite in ((target, tlora.apply_lora), (draft, tlora.apply_lora),
                         (target, tlora.remove_lora)):
        for r in (target, draft, other.runner):
            fill(r)
        args = (ad,) if rewrite is tlora.apply_lora else ()
        rewrite(target.params, *args, runner=via)
        for r in (target, draft):
            assert not r._graphs and not r._greedy_io and r._pool is None
        assert other.runner._graphs and other.runner._pool is not None
    assert draft.params["layers"][0] is target.params["layers"][0]
    assert "wq" in draft.params["layers"][0]["attn"]  # unfused in place
    del draft, via, r
    gc.collect()
    assert list(target._param_sharers) == [target]  # a weak tie


def test_runner_over_adapted_params(files):
    """A runner made over adapted params (as Engine.load makes it) and the
    engine's own runner after apply_lora give the same logits."""
    from llama_gguf_tpu_torch.models.loader import load_model

    params, cfg, _ = load_model(files["Q4_K"], mode="quant", device="cpu")
    ad = tlora.LoraAdapter.load_gguf(files["adapter-Q4_K"])
    tlora.apply_lora(params, ad)
    fresh = ModelRunner(params, cfg, max_seq=160, device="cpu")
    tt = Engine.load(files["Q4_K"], EngineConfig(weight_mode="quant"),
                     device="cpu")
    tlora.apply_lora(tt.runner.params, ad, runner=tt.runner)
    np.testing.assert_array_equal(logits_of(fresh)[0],
                                  logits_of(tt.runner)[0])


def test_fusion_passes_an_adapter_through():
    """fuse_linears leaves a LoraLinear unfused, and apply_qkv applies an
    adapted q next to plain k and v as apply does each; unfuse_linear
    inverts fuse_linears with contiguous slices, as the JAX one slices."""
    from llama_gguf_tpu_torch.ops import linear as L

    g = torch.Generator().manual_seed(0)
    w = [L.DenseLinear(torch.randn(16, n, generator=g),
                       torch.randn(n, generator=g)) for n in (16, 8, 8)]
    ad = L.LoraLinear(w[0], torch.randn(16, 2, generator=g),
                      torch.randn(2, 16, generator=g), 0.5)
    assert L.fuse_linears([ad, w[1], w[2]]) is None
    x = torch.randn(3, 16, generator=g)
    q, k, v = L.apply_qkv({"wq": ad, "wk": w[1], "wv": w[2]}, x)
    want = x @ w[0].weight + w[0].bias + (x @ ad.a) @ ad.b * 0.5
    torch.testing.assert_close(q, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(k, L.apply(w[1], x))
    fused = L.fuse_linears(w)
    parts = L.unfuse_linear(fused, list(fused.splits))
    for got, want_lin in zip(parts, w):
        assert got.weight.is_contiguous() and got.splits is None
        assert torch.equal(got.weight, want_lin.weight)
        assert torch.equal(got.bias, want_lin.bias)


def test_f16_adapter_dequantized_as_jax(tmp_path):
    """Adapter tensors of another GGML type (F16 here) go through the
    port's own dequantize, to JAX's values."""
    rng = np.random.default_rng(7)
    w = GGUFWriter()
    w.add_metadata("general.type", "adapter")
    w.add_metadata("adapter.lora.alpha", 4.0)
    w.add_tensor_np("blk.0.attn_q.weight.lora_a",
                    rng.normal(size=(2, 64)).astype(np.float16))
    w.add_tensor_np("blk.0.attn_q.weight.lora_b",
                    rng.normal(size=(64, 2)).astype(np.float16))
    p = str(tmp_path / "f16.gguf")
    w.write_to_path(p)
    ad, jad = tlora.LoraAdapter.load_gguf(p), jlora.LoraAdapter.load_gguf(p)
    assert (ad.rank, ad.scale) == (jad.rank, jad.scale) == (2, 2.0)
    for got, want in zip(ad.tensors["blk.0.attn_q"],
                         jad.tensors["blk.0.attn_q"]):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
