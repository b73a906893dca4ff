"""The port's CLI ``serve`` and ``chat`` subcommands on the CPU (``--device
cpu``), and both refusing to start without CUDA when no device is given.
``chat``'s replies are held against the JAX package's ChatEngine on the same
tiny model (greedy: the same text); ``run`` on a T5 GGUF and ``embed`` on
BERT and t5encoder GGUFs against the JAX engine's text and vectors."""

import io
import socket
import threading
import time

import pytest
import torch

from fixtures import make_tiny_model
from llama_gguf_tpu.engine.engine import ChatEngine as JChatEngine
from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler

from llama_gguf_tpu_torch import cli
from llama_gguf_tpu_torch.client import RemoteChatClient
from llama_gguf_tpu_torch.server import app


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "tiny.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=96, seed=11,
                    tokenizer=True, quant=GGMLType.Q8_0)
    return path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_answers_health(model_path, monkeypatch):
    """``serve --device cpu`` in a thread answers /health and a completion;
    the test keeps the ServerState run_server makes, to stop it."""
    states = []
    real = app.run_server

    def run(config, state=None):
        state = app.ServerState(config)
        states.append(state)
        real(config, state)

    monkeypatch.setattr(app, "run_server", run)
    port = _free_port()
    thread = threading.Thread(target=cli.main, args=([
        "serve", model_path, "--device", "cpu", "--port", str(port),
        "--max-batch", "2"],), daemon=True)
    thread.start()
    client = RemoteChatClient(f"http://127.0.0.1:{port}", timeout=60)
    try:
        for _ in range(300):
            try:
                health = client.health()
                break
            except OSError:
                time.sleep(0.1)
        assert health == {"status": "ok", "model": "tiny.gguf"}
        assert client.queue_status()["max_batch"] == 2
        assert isinstance(client.complete("hi", temperature=0.0,
                                          max_tokens=4), str)
    finally:
        if states:
            states[0].shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_serve_flags_make_the_config(model_path):
    """``serve``'s flags, ``--prefill-chunk`` among them, are the
    ServerConfig it serves, and the chunk reaches the batched engine."""
    config = cli.serve_config(cli.build_parser().parse_args([
        "serve", model_path, "--device", "cpu", "--max-batch", "2",
        "--prefill-chunk", "16", "--max-queue", "5"]))
    assert (config.prefill_chunk, config.max_batch, config.max_queue,
            config.device) == (16, 2, 5, "cpu")
    default = cli.serve_config(cli.build_parser().parse_args([
        "serve", model_path]))
    assert default.prefill_chunk == app.ServerConfig().prefill_chunk == 512
    config.warmup = False
    state = app.ServerState(config)
    try:
        assert state.current()[1].prefill_chunk == 16
    finally:
        state.shutdown()


def test_chat_with_piped_input(model_path, monkeypatch, capsys):
    lines = ["Hello", "/reset", "Hello", "And then?"]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    assert cli.main(["chat", model_path, "--device", "cpu", "-n", "8",
                     "-t", "0", "--repeat-penalty", "1.0",
                     "--system", "Be brief."]) == 0
    out = capsys.readouterr().out
    assert out.startswith("(interactive chat")
    replies = []
    for line in out.split("\n")[1:]:  # replies may hold \x1e etc.
        while line.startswith("> "):  # input()'s prompts
            line = line[2:]
        if line:
            replies.append(line)
    ref = JChatEngine(JEngine.load(model_path,
                                   JConfig(weight_mode="dequant")),
                      system_prompt="Be brief.")
    greedy = JSampler(temperature=0.0, repetition_penalty=1.0)
    first = ref.send("Hello", max_tokens=8, sampler=greedy)
    ref.reset()
    want = [first] + [ref.send(x, max_tokens=8, sampler=greedy)
                      for x in ("Hello", "And then?")]
    assert replies == [w for w in want if w]


@pytest.mark.parametrize("command", [
    ["serve", "--port", "0"], ["chat"]], ids=["serve", "chat"])
def test_commands_raise_without_cuda(model_path, command):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([command[0], model_path] + command[1:])


def test_serve_rag_db_is_not_ported(model_path, tmp_path):
    """``serve --rag-db`` raised until ROADMAP item 13 ported RAG; now its
    ServerConfig carries the file and the server opens a knowledge base on
    it that generates with the served model."""
    db = str(tmp_path / "kb.sqlite")
    args = cli.build_parser().parse_args(
        ["serve", model_path, "--device", "cpu", "--max-batch", "2",
         "--rag-db", db])
    config = cli.serve_config(args)
    assert config.rag_db == db
    state = app.ServerState(config)
    try:
        assert state.kb is not None and state.kb.store.path == db
        assert state.kb.engine is state.engine
    finally:
        state.shutdown()


def test_run_on_t5(tmp_path, capsys):
    """`run` on a T5 GGUF: seq2seq generation through the engine, the text
    of the JAX engine's greedy generation."""
    from llama_gguf_tpu.utils.synthetic import build_synthetic_t5

    path = build_synthetic_t5(str(tmp_path / "t5.gguf"), gated=True)
    assert cli.main(["run", path, "--device", "cpu", "-p", "translate: hi",
                     "-n", "12", "-t", "0", "--repeat-penalty", "1.0",
                     "--no-stream"]) == 0
    out = capsys.readouterr().out
    want = JEngine.load(path, JConfig(weight_mode="quant")).generate(
        "translate: hi", max_tokens=12,
        sampler=JSampler(temperature=0.0, repetition_penalty=1.0))
    assert out == want + "\n"


@pytest.mark.parametrize("kind", ["bert", "t5encoder"])
def test_embed_on_encoders(tmp_path, capsys, kind):
    """`embed --json` on a BERT and a t5encoder GGUF: the JAX engine's
    vectors within 1e-5."""
    import json

    import numpy as np

    from test_bert_mamba import build_bert_gguf

    from llama_gguf_tpu.utils.synthetic import build_synthetic_t5

    path = str(tmp_path / f"{kind}.gguf")
    if kind == "bert":
        build_bert_gguf(path)
    else:
        build_synthetic_t5(path, decoder=False)
    texts = ["tok3 tok9 tok17", "tok40 tok2"]
    assert cli.main(["embed", path, "--device", "cpu", "--json",
                     "--pooling", "mean", "-p", texts[0], "-p",
                     texts[1]]) == 0
    got = np.array(json.loads(capsys.readouterr().out))
    jeng = JEngine.load(path, JConfig(weight_mode="quant"))
    want = np.array([jeng.embed(t, pooling="mean") for t in texts])
    assert np.abs(got - want).max() <= 1e-5
