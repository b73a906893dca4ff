"""The port's tokenizer.json reader (tokenizer/hf_json.py) against the JAX
package's HFTokenizer and the `tokenizers` library on the same files:
byte-level BPE, WordPiece, Unigram with Metaspace, added special tokens and
the template, the Sequence post-processor, long text. Ids and decoded text
must be equal."""

import json

import pytest

from llama_gguf_tpu.tokenizer.hf_json import HFTokenizer as JHFTokenizer

from llama_gguf_tpu_torch.tokenizer.hf_json import HFTokenizer

SAMPLES = ["hello world", "The quick brown fox jumps over the lazy dog.",
           "numbers 123 and 4567", "unicode café straße",
           "  leading and trailing  ", ""]


def _compare(tmp_path, tok, samples=SAMPLES):
    """Save a `tokenizers` tokenizer; the port's reader gives its ids, and
    the JAX reader's ids and text, on every sample."""
    path = str(tmp_path / "tokenizer.json")
    tok.save(path)
    ours, theirs = HFTokenizer(path), JHFTokenizer(path)
    for s in samples:
        want = tok.encode(s, add_special_tokens=False).ids
        got = ours.encode(s, add_bos=False, add_special=False)
        assert got == want, (s, got, want)
        assert got == theirs.encode(s, add_bos=False, add_special=False)
        assert ours.encode(s) == theirs.encode(s)
        assert ours.decode(got) == theirs.decode(got) == \
            tok.decode(want, skip_special_tokens=True)
    assert ours.vocab_size == theirs.vocab_size
    assert (ours.bos_id, ours.eos_id, ours.unk_id) == \
        (theirs.bos_id, theirs.eos_id, theirs.unk_id)


def test_byte_level_bpe(tmp_path):
    from tokenizers import Tokenizer
    from tokenizers.decoders import ByteLevel as ByteLevelDecoder
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import ByteLevel
    from tokenizers.trainers import BpeTrainer

    tok = Tokenizer(BPE())
    tok.pre_tokenizer = ByteLevel(add_prefix_space=False)
    tok.decoder = ByteLevelDecoder()
    trainer = BpeTrainer(vocab_size=400, special_tokens=["<|endoftext|>"],
                         initial_alphabet=ByteLevel.alphabet(),
                         show_progress=False)
    tok.train_from_iterator(
        ["hello world", "the quick brown fox", "numbers 123 and text",
         "unicode café straße", "more text for merges to appear"] * 20,
        trainer)
    _compare(tmp_path, tok)


def test_wordpiece(tmp_path):
    from tokenizers import Tokenizer
    from tokenizers.decoders import WordPiece as WordPieceDecoder
    from tokenizers.models import WordPiece
    from tokenizers.normalizers import Lowercase
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import WordPieceTrainer

    tok = Tokenizer(WordPiece(unk_token="[UNK]"))
    tok.normalizer = Lowercase()
    tok.pre_tokenizer = Whitespace()
    tok.decoder = WordPieceDecoder()
    trainer = WordPieceTrainer(vocab_size=300,
                               special_tokens=["[UNK]", "[CLS]", "[SEP]"],
                               show_progress=False)
    tok.train_from_iterator(
        ["hello world", "the quick brown fox jumps", "wordpiece pieces",
         "subword tokenization works"] * 20, trainer)
    _compare(tmp_path, tok, samples=[s for s in SAMPLES if s])


def test_unigram_metaspace(tmp_path):
    from tokenizers import Tokenizer
    from tokenizers.decoders import Metaspace as MetaspaceDecoder
    from tokenizers.models import Unigram
    from tokenizers.pre_tokenizers import Metaspace
    from tokenizers.trainers import UnigramTrainer

    tok = Tokenizer(Unigram())
    tok.pre_tokenizer = Metaspace()
    tok.decoder = MetaspaceDecoder()
    trainer = UnigramTrainer(vocab_size=200, special_tokens=["<unk>"],
                             unk_token="<unk>", show_progress=False)
    tok.train_from_iterator(
        ["hello world", "the quick brown fox", "sentence piece style",
         "unigram language model"] * 20, trainer)
    _compare(tmp_path, tok, samples=["hello world", "quick fox style",
                                     "unigram model text"])


def test_special_tokens_and_template(tmp_path):
    from tokenizers import Tokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import ByteLevel
    from tokenizers.processors import TemplateProcessing
    from tokenizers.trainers import BpeTrainer

    tok = Tokenizer(BPE())
    tok.pre_tokenizer = ByteLevel(add_prefix_space=False)
    trainer = BpeTrainer(vocab_size=300, special_tokens=["<s>", "</s>"],
                         initial_alphabet=ByteLevel.alphabet(),
                         show_progress=False)
    tok.train_from_iterator(["hello world example text"] * 40, trainer)
    bos, eos = tok.token_to_id("<s>"), tok.token_to_id("</s>")
    tok.post_processor = TemplateProcessing(
        single="<s> $A", pair="<s> $A </s> $B",
        special_tokens=[("<s>", bos), ("</s>", eos)])
    path = str(tmp_path / "tokenizer.json")
    tok.save(path)
    ours, theirs = HFTokenizer(path), JHFTokenizer(path)
    assert ours.bos_id == bos and ours.add_bos
    s = "hello world"
    assert ours.encode(s) == theirs.encode(s) == \
        tok.encode(s, add_special_tokens=True).ids
    mixed = "hello <s> world"
    got = ours.encode(mixed, add_bos=False, add_special=False)
    assert bos in got
    assert got == theirs.encode(mixed, add_bos=False, add_special=False)


def test_sequence_post_processor(tmp_path):
    vocab = {"<|begin_of_text|>": 0, "h": 1, "i": 2, "hi": 3}
    tokjson = {
        "model": {"type": "BPE", "vocab": vocab, "merges": ["h i"]},
        "added_tokens": [
            {"id": 0, "content": "<|begin_of_text|>", "special": True}],
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                          "use_regex": True},
        "post_processor": {
            "type": "Sequence",
            "processors": [
                {"type": "ByteLevel", "trim_offsets": True},
                {"type": "TemplateProcessing",
                 "single": [
                     {"SpecialToken": {"id": "<|begin_of_text|>",
                                       "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}}],
                 "pair": [],
                 "special_tokens": {
                     "<|begin_of_text|>": {"id": "<|begin_of_text|>",
                                           "ids": [0],
                                           "tokens": ["<|begin_of_text|>"]}}},
            ],
        },
    }
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(tokjson))
    tok, jtok = HFTokenizer(str(path)), JHFTokenizer(str(path))
    assert tok.add_bos and tok.bos_id == 0
    assert tok.encode("hi") == jtok.encode("hi") == [0, 3]
    # a prompt already starting with the bos token gets no second one
    assert tok.encode("<|begin_of_text|>hi") == \
        jtok.encode("<|begin_of_text|>hi") == [0, 3]


@pytest.mark.parametrize("reps", [2000])
def test_long_text_bpe(tmp_path, reps):
    """SPM-style (null pre-tokenizer) BPE on a 24k-character piece: exact,
    and equal to JAX's."""
    letters = "abcdefgh"
    vocab = {c: i for i, c in enumerate(letters)}
    merges = []
    for a in letters[:4]:
        for b in letters[:4]:
            vocab.setdefault(a + b, len(vocab))
            merges.append(f"{a} {b}")
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps({
        "model": {"type": "BPE", "vocab": vocab, "merges": merges},
        "pre_tokenizer": None}))
    tok, jtok = HFTokenizer(str(path)), JHFTokenizer(str(path))
    text = "abcdabcdabab" * reps
    ids = tok.encode(text, add_special=False)
    assert ids == jtok.encode(text, add_special=False)
    assert tok.decode(ids) == text


def test_streaming_decoder_and_eog(tmp_path):
    """The engine's interface on an HF tokenizer: the streaming decoder
    joins to decode's text, and eos is end-of-generation."""
    from tokenizers import Tokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import ByteLevel
    from tokenizers.processors import TemplateProcessing
    from tokenizers.trainers import BpeTrainer

    tok = Tokenizer(BPE())
    tok.pre_tokenizer = ByteLevel(add_prefix_space=False)
    trainer = BpeTrainer(vocab_size=300, special_tokens=["<s>", "</s>"],
                         initial_alphabet=ByteLevel.alphabet(),
                         show_progress=False)
    tok.train_from_iterator(["stream me café please"] * 40, trainer)
    eos = tok.token_to_id("</s>")
    tok.post_processor = TemplateProcessing(
        single="<s> $A </s>", special_tokens=[("<s>", 0), ("</s>", eos)])
    path = str(tmp_path / "tokenizer.json")
    tok.save(path)
    ours = HFTokenizer(path)
    ids = ours.encode("stream me café please", add_bos=False,
                      add_special=False)
    dec = ours.streaming_decoder()
    assert "".join(dec.push(i) for i in ids) + dec.flush() == \
        ours.decode(ids) == "stream me café please"
    assert ours.is_eog(ours.eos_id)
