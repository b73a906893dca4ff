"""The port's config.py, manpages.py, hub.py and the CLI's local
subcommands and flags against the JAX package's on the CPU.

Config: the same values from defaults, TOML and LLAMA_GGUF_* variables,
and the same example text. CLI (``--device cpu`` for the port): tokenize,
init-config and models print the same text; embed --json within 1e-5;
perplexity --json within 1e-5 relative; manpages render the same pages for
the same parser; run with --context-shift and --prompt-cache as the JAX
run; sysinfo names torch and says when there is no card. The precedence of
every option: flag > environment > TOML > default."""

import json
import os

import numpy as np
import pytest
import torch

from fixtures import make_tiny_model
from llama_gguf_tpu import cli as jcli
from llama_gguf_tpu import config as jconfig
from llama_gguf_tpu import manpages as jmanpages
from llama_gguf_tpu.gguf.constants import GGMLType

from llama_gguf_tpu_torch import cli, config, hub, manpages

ENV = ("LLAMA_GGUF_SERVER_PORT", "LLAMA_GGUF_GENERATION_STOP",
       "LLAMA_GGUF_GENERATION_TEMPERATURE", "LLAMA_GGUF_MODEL_WEIGHT_MODE",
       "LLAMA_GGUF_EMBED_NORMALIZE", "LLAMA_GGUF_GENERATION_MAX_TOKENS",
       "LLAMA_GGUF_CACHE_DIR")
TOML = """
[model]
weight_mode = "dequant"
max_context_len = 80
[generation]
temperature = 0.1
max_tokens = 7
stop = ["x", "y"]
[server]
port = 9999
api_keys = ["k1"]
[embed]
pooling = "last"
[rag]
top_k = 9
[parallel]
model = 1
"""


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "tiny.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=96, seed=11,
                    tokenizer=True)
    return path


# -- config -------------------------------------------------------------------


def test_config_defaults_and_example_match_jax():
    assert config.Config().to_dict() == jconfig.Config().to_dict()
    assert config.example_config() == jconfig.example_config()


def test_config_toml_and_env_match_jax(tmp_path, monkeypatch):
    p = tmp_path / "c.toml"
    p.write_text(TOML)
    for apply_env in (False, True):
        got = config.Config.load(str(p), apply_env=apply_env)
        assert got.to_dict() == jconfig.Config.load(
            str(p), apply_env=apply_env).to_dict()
    monkeypatch.setenv("LLAMA_GGUF_SERVER_PORT", "7777")
    monkeypatch.setenv("LLAMA_GGUF_GENERATION_STOP", "a,b")
    monkeypatch.setenv("LLAMA_GGUF_EMBED_NORMALIZE", "off")
    monkeypatch.setenv("LLAMA_GGUF_GENERATION_TEMPERATURE", "0.5")
    got = config.Config.load(str(p))
    assert got.to_dict() == jconfig.Config.load(str(p)).to_dict()
    assert (got.server.port, got.generation.stop, got.embed.normalize,
            got.generation.temperature, got.generation.max_tokens) == \
        (7777, ["a", "b"], False, 0.5, 7)
    ex = tmp_path / "ex.toml"
    ex.write_text(config.example_config())
    assert config.Config.load(str(ex), apply_env=False).to_dict() == \
        jconfig.Config.load(str(ex), apply_env=False).to_dict()
    with pytest.raises(FileNotFoundError):
        config.Config.load(str(tmp_path / "missing.toml"))


def test_flags_beat_env_beat_toml(tmp_path, monkeypatch, model_path):
    p = tmp_path / "c.toml"
    p.write_text(TOML)
    parse = cli.build_parser().parse_args
    args = parse(["run", model_path, "--config", str(p), "--device", "cpu"])
    cfg = cli._load_config(args)
    ec = cli._engine_config(cfg, args)
    assert (ec.weight_mode, ec.max_context_len) == ("dequant", 80)
    assert cli._sampler(cfg, args).temperature == 0.1
    monkeypatch.setenv("LLAMA_GGUF_MODEL_WEIGHT_MODE", "quant")
    monkeypatch.setenv("LLAMA_GGUF_GENERATION_TEMPERATURE", "0.3")
    cfg = cli._load_config(args)
    assert cli._engine_config(cfg, args).weight_mode == "quant"
    assert cli._sampler(cfg, args).temperature == 0.3
    args = parse(["run", model_path, "--config", str(p), "-t", "0",
                  "--weight-mode", "dequant", "--ctx", "64", "--seed", "0",
                  "--context-shift", "--prompt-cache", "s.bin"])
    ec = cli._engine_config(cli._load_config(args), args)
    assert (ec.weight_mode, ec.max_context_len, ec.seed, ec.context_shift,
            ec.prompt_cache_file) == ("dequant", 64, 0, True, "s.bin")
    assert cli._sampler(cli._load_config(args), args).temperature == 0.0
    sc = cli.serve_config(parse(["serve", model_path, "--config", str(p),
                                 "--max-batch", "3"]))
    assert (sc.port, sc.max_batch, sc.api_keys, sc.weight_mode,
            sc.max_tokens_default, sc.max_context_len) == \
        (9999, 3, ["k1"], "quant", 7, 80)


def test_unported_config_values_raise(tmp_path, model_path, capsys):
    """Two config values that raised until item 12 ported them now run as
    the JAX CLI runs them: a mesh ([parallel] model = 2: two ranks, two
    processes here, over gloo on the CPU) and the TOML's [model].lora."""
    from test_torch_lora import shapes_of, write_lora

    p = tmp_path / "c.toml"
    p.write_text("[parallel]\nmodel = 2\n")
    argv = ["run", model_path, "--config", str(p), "-p", "hi", "-n", "4",
            "-t", "0", "--weight-mode", "dequant"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert got == capsys.readouterr().out
    adapter = write_lora(str(tmp_path / "a.gguf"), alpha=32.0, seed=3,
                         layers=2, shapes=shapes_of(64, 128))
    p.write_text(f'[model]\nlora = "{adapter}"\n')
    argv = ["run", model_path, "--config", str(p), "-p", "hi", "-n", "4",
            "-t", "0", "--weight-mode", "dequant"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert got == capsys.readouterr().out
    # every KV format is ported: the i8 cache runs
    assert cli.main(["run", model_path, "--kv-cache-type", "i8", "--device",
                     "cpu", "-p", "hi", "-n", "2"]) == 0


# -- subcommands ----------------------------------------------------------------


def both(capsys, argv: list[str], port_extra=("--device", "cpu")):
    """(port stdout, JAX stdout) of the same subcommand."""
    assert cli.main(argv + list(port_extra)) == 0
    got = capsys.readouterr().out
    assert jcli.main(argv) == 0
    return got, capsys.readouterr().out


def test_tokenize_matches_jax(model_path, capsys):
    for argv in (["-p", "hello wörld"], ["-p", "hi", "--no-bos"],
                 ["--ids", "5,9 40"]):
        got, want = both(capsys, ["tokenize", model_path] + argv, ())
        assert got == want and got


def test_embed_json_matches_jax(model_path, capsys):
    for extra in ([], ["--pooling", "max", "--no-normalize"]):
        got, want = both(capsys, ["embed", model_path, "-p", "hello", "-p",
                                  "world", "--weight-mode", "dequant",
                                  "--json"] + extra)
        got, want = json.loads(got), json.loads(want)
        assert np.shape(got) == np.shape(want) == (2, 64)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_embed_text_output(model_path, capsys):
    got, want = both(capsys, ["embed", model_path, "-p", "hello", "-p",
                              "world", "--weight-mode", "dequant"])
    assert got.splitlines()[-1].startswith("cosine similarity: ")
    assert len(got.splitlines()) == len(want.splitlines()) == 3


@pytest.mark.parametrize("mode", ["quant", "dequant"])
def test_perplexity_json_matches_jax(model_path, tmp_path, capsys, mode):
    f = tmp_path / "text.txt"
    f.write_text("tok1 tok2 tok3 tok4 tok5 tok6 tok7 tok8 " * 4)
    got, want = both(capsys, ["perplexity", model_path, "-f", str(f),
                              "--chunk", "16", "--weight-mode", mode,
                              "--json"])
    got = json.loads(got.strip().splitlines()[-1])
    want = json.loads(want.strip().splitlines()[-1])
    assert got["tokens"] == want["tokens"] > 0
    for key in ("ppl", "nll"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)


def test_perplexity_text_output(model_path, tmp_path, capsys):
    f = tmp_path / "text.txt"
    f.write_text("tok1 tok2 tok3 tok4 " * 8)
    assert cli.main(["perplexity", model_path, "-f", str(f), "--device",
                     "cpu"]) == 0
    out = capsys.readouterr()
    assert out.out.startswith("perplexity: ") and "ppl=" in out.err


def test_init_config_writes_the_jax_file(tmp_path, capsys):
    paths = [str(tmp_path / f"{who}.toml") for who in ("port", "jax")]
    assert cli.main(["init-config", paths[0]]) == 0
    assert jcli.main(["init-config", paths[1]]) == 0
    texts = [open(p).read() for p in paths]
    assert texts[0] == texts[1] == config.example_config()
    with pytest.raises(SystemExit, match="already exists"):
        cli.main(["init-config", paths[0]])


def test_manpages(tmp_path, capsys):
    """The port's renderer gives the JAX pages for the JAX parser; its own
    parser gives a page for the command and each subcommand."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    parser = jcli.build_parser()
    assert manpages.write_manpages(parser, tdir) == \
        jmanpages.write_manpages(parser, jdir)
    for name in os.listdir(os.path.join(jdir, "man1")):
        assert open(os.path.join(tdir, "man1", name)).read() == \
            open(os.path.join(jdir, "man1", name)).read()
    out = str(tmp_path / "man")
    assert cli.main(["manpages", "--dir", out]) == 0
    pages = sorted(os.listdir(os.path.join(out, "man1")))
    subs = cli.build_parser()._subparsers._group_actions[0].choices
    assert pages == sorted(["llama-gguf-tpu-torch.1"] + [
        f"llama-gguf-tpu-torch-{c}.1" for c in subs])
    assert len(subs) == 17  # with shard, cluster, download and rag
    text = open(os.path.join(out, "man1", "llama-gguf-tpu-torch.1")).read()
    assert ".TH" in text and ".SH NAME" in text and "perplexity" in text


def test_models_lists_as_jax(tmp_path, capsys, model_path):
    empty = str(tmp_path / "nocache")
    got, want = both(capsys, ["models", "--dir", empty], ())
    assert got == want == ""
    d = tmp_path / "cache" / "org"
    d.mkdir(parents=True)
    for name in ("a.gguf", "b.gguf", "notes.txt"):
        (d / name).write_bytes(open(model_path, "rb").read()[:1000 + len(
            name)])
    os.utime(d / "a.gguf", (1, 1))
    got, want = both(capsys, ["models", "--dir", str(tmp_path / "cache")], ())
    assert got == want and got.count("\n") == 2
    assert got.index("b.gguf") < got.index("a.gguf")  # newest first
    assert [p for p, _ in hub.HubClient(str(tmp_path / "cache"))
            .list_local_models()] == [str(d / "b.gguf"), str(d / "a.gguf")]


def test_sysinfo(capsys):
    assert cli.main(["sysinfo"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"torch {torch.__version__}")
    assert "devices:" in out and "kernel build directory:" in out
    if not torch.cuda.is_available():
        assert "devices: 0 (no CUDA device" in out


def test_run_context_shift_and_prompt_cache_match_jax(model_path, tmp_path,
                                                      capsys):
    """run with --context-shift in a 32-token window and a greedy
    generation that stays within it (the JAX cut keeps the prompt), then
    run twice with --prompt-cache: the same text as the JAX CLI's, the
    session file saved by the first run and hit by the second."""
    argv = ["run", model_path, "-p", "tok1 tok2", "-n", "6", "-t", "0",
            "--repeat-penalty", "1.0", "--weight-mode", "dequant",
            "--no-stream"]
    got, want = both(capsys, argv + ["--ctx", "32", "--context-shift"])
    assert got == want
    sess = {who: str(tmp_path / f"{who}.bin") for who in ("port", "jax")}
    for _ in range(2):
        assert cli.main(argv + ["--prompt-cache", sess["port"], "--device",
                                "cpu"]) == 0
        out = capsys.readouterr()
        assert jcli.main(argv + ["--prompt-cache", sess["jax"]]) == 0
        jout = capsys.readouterr()
        assert out.out == jout.out
        assert f"[prompt cache saved to {sess['port']}]" in out.err
    from llama_gguf_tpu_torch.engine.prompt_cache import PromptCache

    cache = PromptCache()
    assert cache.load(sess["jax"]) == 1
    assert next(iter(cache._entries.values())).hits == 1


def test_chat_saves_the_prompt_cache(model_path, tmp_path, monkeypatch,
                                     capsys):
    import io

    sess = str(tmp_path / "chat.bin")
    monkeypatch.setattr("sys.stdin", io.StringIO("Hello\n/exit\n"))
    assert cli.main(["chat", model_path, "--device", "cpu", "-n", "4", "-t",
                     "0", "--prompt-cache", sess]) == 0
    assert f"[prompt cache saved to {sess}]" in capsys.readouterr().err
    assert os.path.exists(sess)


def test_quantize_takes_the_config(model_path, tmp_path):
    p = tmp_path / "c.toml"
    p.write_text('[quantize]\ntype = "q8_0"\n')
    out = str(tmp_path / "q.gguf")
    assert cli.main(["quantize", model_path, out, "--config", str(p)]) == 0
    from llama_gguf_tpu_torch.gguf.reader import GGUFFile

    g = GGUFFile.open(out)
    try:
        assert GGMLType.Q8_0.name in {i.ggml_type.name
                                      for i in g.tensors.values()}
    finally:
        g.close()
