"""The port's chat templates (engine/chat.py), grammar machines
(sampling/grammar.py), grammar-constrained generation, embeddings
(models/embeddings.py) and ChatEngine against the JAX package on the CPU.

Templates and grammar masks are exact (the same strings and boolean masks).
Generation runs the qwen2 tiny model of tests/test_batched.py with Q8_0
weights: the port in "quant" mode (the q8 kernel's plain version), the JAX
engine in "dequant" mode (the same dequantized weights), greedy: the same
text. Embeddings: within 1e-5 (f32 hidden states, another order of
summation), on that qwen2 model and on tiny gemma, gemma2 and gpt2 models,
whose embeddings the JAX package takes without learned positions and, for
the Gemma family, with a final norm by (1 + w)."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from fixtures import make_tiny_model
from llama_gguf_tpu.engine.chat import ChatTemplate as JChatTemplate
from llama_gguf_tpu.engine.engine import ChatEngine as JChatEngine
from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.sampling import grammar as JG
from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler

from llama_gguf_tpu_torch.engine.chat import ChatTemplate
from llama_gguf_tpu_torch.engine.engine import ChatEngine, Engine, EngineConfig
from llama_gguf_tpu_torch.sampling import grammar as G
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

EMBED_TOL = 1e-5
GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
JGREEDY = JSampler(temperature=0.0, repetition_penalty=1.0)

MESSAGES = [
    {"role": "system", "content": "You are terse."},
    {"role": "user", "content": "Hi there"},
    {"role": "assistant", "content": "Hello."},
    {"role": "user", "content": "What is 2+2?"},
]
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Weather for a city",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}}]
JINJA = ("{% for m in messages %}<{{ m['role'] }}>{{ m['content'] }}</s>"
         "{% endfor %}{% if tools %}[{{ tools | tojson }}]{% endif %}"
         "{% if add_generation_prompt %}<assistant>{% endif %}")
STYLES = ["chatml", "llama2", "llama3", "gemma", "phi", "plain", "jinja"]


@pytest.mark.parametrize("tools", [None, TOOLS], ids=["plain", "tools"])
@pytest.mark.parametrize("gen", [True, False], ids=["gen", "nogen"])
@pytest.mark.parametrize("style", STYLES)
def test_template_renders_as_jax(style, gen, tools):
    src = JINJA if style == "jinja" else None
    got = ChatTemplate(style, src).render(MESSAGES, gen, tools)
    want = JChatTemplate(style, src).render(MESSAGES, gen, tools)
    assert got == want
    assert ChatTemplate(style).stop == JChatTemplate(style).stop


@pytest.mark.parametrize("tokens,template", [
    (["a", "<|im_start|>", "<|im_end|>"], None),
    (["<|start_header_id|>", "x"], None),
    (["<start_of_turn>"], None),
    (["<|user|>", "<|assistant|>"], None),
    (["▁[INST]"], None),
    (["a", "b"], None),
    (["<|im_start|>"], JINJA),
], ids=["chatml", "llama3", "gemma", "phi", "llama2", "plain", "jinja"])
def test_detect_matches_jax(tokens, template):
    tok = SimpleNamespace(tokens=tokens, chat_template=template)
    got, want = ChatTemplate.detect(tok), JChatTemplate.detect(tok)
    assert (got.style, got.jinja_source) == (want.style, want.jinja_source)


NESTED = """
root ::= greeting " " name
greeting ::= "hi" | "hello"
name ::= [A-Z] [a-z]*
"""
OBJECT = {"type": "object",
          "properties": {"name": {"type": "string"},
                         "age": {"type": "integer"}},
          "required": ["name", "age"]}
GRAMMARS = [  # (kind, spec, a text the grammar accepts)
    ("gbnf", 'root ::= "yes" | "no"', "yes"),
    ("gbnf", 'root ::= "a"+ "b"*', "aaabb"),
    ("gbnf", "root ::= [a-c0-9]+", "a0c9"),
    ("gbnf", "root ::= [^x]*", "abc"),
    ("gbnf", NESTED, "hello Bob"),
    ("gbnf", "root ::= [0-9]{2,4}", "1234"),
    ("gbnf", 'root ::= "(" root ")" | ""', "((()))"),
    ("json", None, '{"a": 1, "b": [true, null], "c": {"d": "e"}}'),
    ("json", OBJECT, '{"name": "bo", "age": 3}'),
    ("json", {"enum": ["red", "green", 3]}, '"red"'),
    ("json", {"type": "array", "items": {"type": "boolean"}},
     "[true, false]"),
    ("regex", r"[a-z]+@[a-z]+\.(com|org)", "bob@corp.com"),
    ("regex", r"\d{3}-\d{4}", "555-1234"),
    ("regex", r"ab?c*", "abccc"),
]
VOCAB = ([chr(c) for c in range(32, 127)]
         + ['{"', '": ', ', "', "true", "false", "null", "yes", "hello",
            "ab", "cc", "12", "@corp", ".com", "\n", "", "<eos>"])


def _machine(mod, kind, spec):
    if kind == "gbnf":
        return mod.gbnf_grammar(spec)
    if kind == "json":
        return mod.json_grammar(spec)
    return mod.regex_grammar(spec)


@pytest.mark.parametrize("kind,spec,text", GRAMMARS,
                         ids=[f"{k}{i}" for i, (k, _, _) in
                              enumerate(GRAMMARS)])
def test_grammar_masks_match_jax(kind, spec, text):
    """Along an accepted text, one character per step: the same token mask
    and completion state at every step, and the same GBNF for schemas."""
    eos = len(VOCAB) - 1
    mine = G.GrammarSampler(_machine(G, kind, spec), VOCAB, eos_token_id=eos)
    ref = JG.GrammarSampler(_machine(JG, kind, spec), VOCAB,
                            eos_token_id=eos)
    for ch in list(text) + [None]:
        np.testing.assert_array_equal(mine.get_token_mask(),
                                      ref.get_token_mask())
        assert mine.is_complete == ref.is_complete
        if ch is not None:
            mine.record_token(ch)
            ref.record_token(ch)
    assert mine.is_complete
    if kind == "json" and spec is not None:
        assert G.schema_to_gbnf(spec) == JG.schema_to_gbnf(spec)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cg") / "tiny.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=96, seed=11,
                    tokenizer=True, quant=GGMLType.Q8_0)
    teng = Engine.load(path, EngineConfig(weight_mode="quant"), device="cpu")
    jeng = JEngine.load(path, JConfig(weight_mode="dequant"))
    return teng, jeng


@pytest.mark.parametrize("schema", [None, {"enum": ["red", "green"]}],
                         ids=["json", "schema"])
def test_generate_with_grammar_matches_jax(engines, schema):
    teng, jeng = engines
    gs = teng.make_grammar_sampler(G.json_grammar(schema))
    jgs = jeng.make_grammar_sampler(JG.json_grammar(schema))
    got = teng.generate("Give me JSON:", max_tokens=40, sampler=GREEDY,
                        grammar=gs)
    want = jeng.generate("Give me JSON:", max_tokens=40, sampler=JGREEDY,
                         grammar=jgs)
    assert got == want
    assert gs.is_complete == jgs.is_complete
    assert gs.is_complete
    json.loads(got)


def write_tiny_gpt2(path: str, seed: int = 11, vocab: int = 288,
                    hidden: int = 64, layers: int = 2, heads: int = 4,
                    ffn: int = 128, ctx: int = 96) -> None:
    """A 2-layer gpt2-family GGUF (learned positions of unit scale,
    LayerNorm with biases, fused QKV, tied head) with the fixtures'
    tokenizer, from seeded random weights."""
    from llama_gguf_tpu.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)

    def randw(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    w = GGUFWriter()
    for key, value in (("general.architecture", "gpt2"),
                       ("gpt2.embedding_length", hidden),
                       ("gpt2.block_count", layers),
                       ("gpt2.attention.head_count", heads),
                       ("gpt2.feed_forward_length", ffn),
                       ("gpt2.context_length", ctx),
                       ("gpt2.attention.layer_norm_epsilon", 1e-5),
                       ("gpt2.vocab_size", vocab)):
        w.add_metadata(key, value)
    # the fixtures' tokenizer: specials, 256 byte tokens, then tokN
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    toks += [f"tok{i}" for i in range(len(toks), vocab)]
    types = [2, 3, 3] + [6] * 256 + [1] * (vocab - 259)
    for key, value in (("tokenizer.ggml.model", "llama"),
                       ("tokenizer.ggml.tokens", toks),
                       ("tokenizer.ggml.scores", np.zeros(vocab, np.float32)),
                       ("tokenizer.ggml.token_type",
                        np.array(types, np.int32)),
                       ("tokenizer.ggml.bos_token_id", 1),
                       ("tokenizer.ggml.eos_token_id", 2),
                       ("tokenizer.ggml.unknown_token_id", 0)):
        w.add_metadata(key, value)
    w.add_tensor_np("token_embd.weight", randw(vocab, hidden))
    w.add_tensor_np("position_embd.weight", randw(ctx, hidden, scale=1.0))
    for i in range(layers):
        p = f"blk.{i}"
        for norm in ("attn_norm", "ffn_norm"):
            w.add_tensor_np(f"{p}.{norm}.weight", 1.0 + randw(hidden))
            w.add_tensor_np(f"{p}.{norm}.bias", randw(hidden))
        for name, n, k in (("attn_qkv", 3 * hidden, hidden),
                           ("attn_output", hidden, hidden),
                           ("ffn_up", ffn, hidden),
                           ("ffn_down", hidden, ffn)):
            w.add_tensor_np(f"{p}.{name}.weight", randw(n, k))
            w.add_tensor_np(f"{p}.{name}.bias", randw(n))
    w.add_tensor_np("output_norm.weight", 1.0 + randw(hidden))
    w.add_tensor_np("output_norm.bias", randw(hidden))
    w.write_to_path(path)


@pytest.fixture(scope="module")
def embed_engines(engines, tmp_path_factory):
    """The port's engine (CPU) and the JAX package's, per model of
    EMBED_MODELS: qwen2 is ``engines``' Q8_0 model; gemma and gemma2 tiny
    F32 models (fixtures.make_tiny_model, seed 11); gpt2 write_tiny_gpt2."""
    out = {"qwen2": engines}
    d = tmp_path_factory.mktemp("embed")
    for arch in ("gemma", "gemma2", "gpt2"):
        path = str(d / f"{arch}.gguf")
        if arch == "gpt2":
            write_tiny_gpt2(path)
        else:
            make_tiny_model(path, arch=arch, vocab=288, hidden=64, layers=2,
                            heads=4, kv_heads=2, ffn=128, ctx=96, seed=11,
                            tokenizer=True)
        out[arch] = (Engine.load(path, EngineConfig(weight_mode="quant"),
                                 device="cpu"),
                     JEngine.load(path, JConfig(weight_mode="dequant")))
    return out


EMBED_MODELS = ("qwen2", "gemma", "gemma2", "gpt2")
POOLINGS = ("mean", "last", "first", "max")


@pytest.mark.parametrize("model,pooling", [
    pytest.param(m, p, id=p if m == "qwen2" else f"{m}-{p}")
    for m in EMBED_MODELS for p in POOLINGS])
def test_embed_matches_jax(embed_engines, model, pooling):
    """Engine.embed equals the JAX package's: no learned position rows
    (gpt2) and the Gemma family's (1 + w) final norm, as its
    extract_hidden_states takes them."""
    teng, jeng = embed_engines[model]
    text = "The quick brown fox jumps over the lazy dog"
    got = teng.embed(text, pooling=pooling)
    want = np.asarray(jeng.embed(text, pooling=pooling))
    assert got.shape == want.shape == (64,)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_TOL)


def test_embedding_helpers_match_jax():
    from llama_gguf_tpu.models import embeddings as JE

    from llama_gguf_tpu_torch.models import embeddings as TE

    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((6, 8)).astype(np.float32)
    q = corpus[2] + 0.1
    for metric in ("cosine", "dot", "euclidean"):
        assert TE.find_nearest(q, corpus, 3, metric) == \
            JE.find_nearest(q, corpus, 3, metric)
    assert TE.cosine_similarity(q, corpus[0]) == \
        JE.cosine_similarity(q, corpus[0])


def test_chat_engine_matches_jax(engines):
    teng, jeng = engines
    mine = ChatEngine(teng, system_prompt="Be brief.")
    ref = JChatEngine(jeng, system_prompt="Be brief.")
    for turn in ("Hello", "And then?"):
        assert mine.send(turn, max_tokens=12, sampler=GREEDY) == \
            ref.send(turn, max_tokens=12, sampler=JGREEDY)
    assert mine.messages == ref.messages
    assert "".join(mine.send_streaming("More", max_tokens=8,
                                       sampler=GREEDY)) == \
        ref.send("More", max_tokens=8, sampler=JGREEDY)
    mine.reset()
    assert mine.messages == [{"role": "system", "content": "Be brief."}]
