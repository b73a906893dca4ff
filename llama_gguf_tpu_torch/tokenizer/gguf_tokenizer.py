"""GGUF-driven tokenizer: SentencePiece-BPE, byte-level BPE, WordPiece,
Unigram, with special-token splitting and UTF-8-safe streaming decode.

The four algorithm families are driven by `tokenizer.ggml.*` metadata. A
copy of llama_gguf_tpu/tokenizer/gguf_tokenizer.py (the port never imports the
JAX package).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping

import numpy as np

# llama.cpp token types (tokenizer.ggml.token_type)
TT_NORMAL = 1
TT_UNKNOWN = 2
TT_CONTROL = 3
TT_USER_DEFINED = 4
TT_UNUSED = 5
TT_BYTE = 6

SPM_SPACE = "▁"  # ▁

# GPT-2 byte-level BPE unicode<->byte tables
def _bytes_to_unicode() -> dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_TO_UNI = _bytes_to_unicode()
_UNI_TO_BYTE = {v: k for k, v in _BYTE_TO_UNI.items()}

# GPT-2 pretokenizer pattern (default); llama3 uses a slightly different one
try:
    import regex as _rx

    _GPT2_PAT = _rx.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
    )
    _LLAMA3_PAT = _rx.compile(
        r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"""
        r""" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
    )
except ImportError:  # pragma: no cover
    _rx = None
    _GPT2_PAT = None
    _LLAMA3_PAT = None


@dataclass
class Tokenizer:
    model: str  # "llama" | "gpt2" | "bert" | "t5"
    tokens: list[str]
    scores: np.ndarray | None = None
    token_types: np.ndarray | None = None
    merges: list[str] | None = None
    bos_id: int | None = None
    eos_id: int | None = None
    unk_id: int | None = None
    pad_id: int | None = None
    add_bos: bool = True
    add_eos: bool = False
    add_space_prefix: bool | None = None
    pre: str = "default"
    chat_template: str | None = None
    eot_ids: tuple[int, ...] = ()
    _vocab: dict[str, int] = field(default_factory=dict, repr=False)
    _merge_ranks: dict[tuple[str, str], int] = field(default_factory=dict, repr=False)
    _byte_tokens: dict[int, int] = field(default_factory=dict, repr=False)
    _special: dict[str, int] = field(default_factory=dict, repr=False)
    _special_re: Any = field(default=None, repr=False)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_gguf(cls, metadata: Mapping[str, Any]) -> "Tokenizer":
        model = str(metadata.get("tokenizer.ggml.model", "llama"))
        tokens = list(metadata.get("tokenizer.ggml.tokens", []))
        scores = metadata.get("tokenizer.ggml.scores")
        if scores is not None:
            scores = np.asarray(scores, np.float32)
        ttypes = metadata.get("tokenizer.ggml.token_type")
        if ttypes is not None:
            ttypes = np.asarray(ttypes, np.int32)
        merges = metadata.get("tokenizer.ggml.merges")
        if merges is not None:
            merges = list(merges)

        def gid(key):
            v = metadata.get(f"tokenizer.ggml.{key}")
            return int(v) if v is not None else None

        tk = cls(
            model=model,
            tokens=tokens,
            scores=scores,
            token_types=ttypes,
            merges=merges,
            bos_id=gid("bos_token_id"),
            eos_id=gid("eos_token_id"),
            unk_id=gid("unknown_token_id"),
            pad_id=gid("padding_token_id"),
            add_bos=bool(metadata.get("tokenizer.ggml.add_bos_token", model == "llama")),
            add_eos=bool(metadata.get("tokenizer.ggml.add_eos_token", False)),
            add_space_prefix=metadata.get("tokenizer.ggml.add_space_prefix"),
            pre=str(metadata.get("tokenizer.ggml.pre", "default")),
            chat_template=metadata.get("tokenizer.chat_template"),
        )
        tk._build()
        return tk

    def _build(self) -> None:
        self._vocab = {t: i for i, t in enumerate(self.tokens)}
        if self.merges:
            self._merge_ranks = {}
            for rank, m in enumerate(self.merges):
                parts = m.split(" ")
                if len(parts) == 2:
                    self._merge_ranks[(parts[0], parts[1])] = rank
        # byte fallback tokens <0xNN>
        for i, t in enumerate(self.tokens):
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                try:
                    self._byte_tokens[int(t[3:5], 16)] = i
                except ValueError:
                    pass
        # special tokens: control + user-defined split before tokenization
        if self.token_types is not None:
            eots = []
            for i, tt in enumerate(self.token_types):
                if tt in (TT_CONTROL, TT_USER_DEFINED) and i < len(self.tokens):
                    self._special[self.tokens[i]] = i
                    name = self.tokens[i]
                    if name in ("<|eot_id|>", "<|im_end|>", "<|end|>",
                                "<|endoftext|>", "</s>", "<end_of_turn>"):
                        eots.append(i)
            self.eot_ids = tuple(eots)
        if self._special:
            pat = "|".join(
                re.escape(t) for t in sorted(self._special, key=len, reverse=True)
            )
            self._special_re = re.compile(f"({pat})")

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # -- encode --------------------------------------------------------------

    def encode(self, text: str, add_bos: bool | None = None,
               add_special: bool = True, parse_special: bool = True) -> list[int]:
        ids: list[int] = []
        use_bos = self.add_bos if add_bos is None else add_bos
        if use_bos and add_special and self.bos_id is not None:
            ids.append(self.bos_id)

        segments: list[tuple[str, bool]] = []
        if parse_special and self._special_re is not None:
            for part in self._special_re.split(text):
                if not part:
                    continue
                segments.append((part, part in self._special))
        else:
            segments.append((text, False))

        first_content = True
        for seg, is_special in segments:
            if is_special:
                ids.append(self._special[seg])
                first_content = False
                continue
            ids.extend(self._encode_segment(seg, first=first_content))
            first_content = False

        if self.add_eos and add_special and self.eos_id is not None:
            ids.append(self.eos_id)
        return ids

    def _encode_segment(self, text: str, first: bool) -> list[int]:
        if not text:
            return []
        if self.model == "llama":
            return self._encode_spm(text, first)
        if self.model == "gpt2":
            return self._encode_bpe(text)
        if self.model == "bert":
            return self._encode_wordpiece(text)
        if self.model == "t5":
            return self._encode_unigram(text, first)
        raise ValueError(f"unknown tokenizer model {self.model}")

    # SentencePiece-style BPE (llama.cpp llm_tokenizer_spm semantics):
    # escape spaces to ▁, greedy best-score bigram merging, byte fallback.
    def _encode_spm(self, text: str, first: bool) -> list[int]:
        prefix = self.add_space_prefix
        if prefix is None:
            prefix = True
        if prefix and first and not text.startswith(" "):
            text = " " + text
        s = text.replace(" ", SPM_SPACE)
        symbols: list[str] = list(s)
        if not symbols:
            return []
        scores = self.scores if self.scores is not None else np.zeros(len(self.tokens))

        def merge_score(a: str, b: str) -> float | None:
            tid = self._vocab.get(a + b)
            if tid is None:
                return None
            return float(scores[tid]) if tid < len(scores) else 0.0

        # iterative best-pair merging
        while True:
            best_i, best_score = -1, -1e30
            for i in range(len(symbols) - 1):
                sc = merge_score(symbols[i], symbols[i + 1])
                if sc is not None and sc > best_score:
                    best_i, best_score = i, sc
            if best_i < 0:
                break
            symbols[best_i : best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]

        ids: list[int] = []
        for sym in symbols:
            tid = self._vocab.get(sym)
            if tid is not None:
                ids.append(tid)
                continue
            for b in sym.encode("utf-8"):
                bid = self._byte_tokens.get(b)
                if bid is not None:
                    ids.append(bid)
                elif self.unk_id is not None:
                    ids.append(self.unk_id)
        return ids

    # GPT-2 byte-level BPE
    def _encode_bpe(self, text: str) -> list[int]:
        if _rx is None:
            raise RuntimeError("regex module required for BPE tokenizer")
        pat = _LLAMA3_PAT if self.pre in ("llama3", "llama-v3", "llama-bpe") else _GPT2_PAT
        ids: list[int] = []
        for piece in pat.findall(text):
            word = "".join(_BYTE_TO_UNI[b] for b in piece.encode("utf-8"))
            for sub in self._bpe_word(word):
                tid = self._vocab.get(sub)
                if tid is not None:
                    ids.append(tid)
                elif self.unk_id is not None:
                    ids.append(self.unk_id)
        return ids

    def _bpe_word(self, word: str) -> list[str]:
        if word in self._vocab:
            return [word]
        parts = list(word)
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self._merge_ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i < 0:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return parts

    # WordPiece (BERT)
    def _encode_wordpiece(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in text.lower().split():
            word = re.sub(r"([^\w\s])", r" \1 ", word)
            for w in word.split():
                ids.extend(self._wordpiece_one(w))
        return ids

    def _wordpiece_one(self, word: str) -> list[int]:
        out: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self._vocab:
                    cur = self._vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id] if self.unk_id is not None else []
            out.append(cur)
            start = end
        return out

    # Unigram (T5) Viterbi
    def _encode_unigram(self, text: str, first: bool) -> list[int]:
        if self.add_space_prefix in (None, True) and first:
            text = " " + text
        s = text.replace(" ", SPM_SPACE)
        n = len(s)
        scores = self.scores if self.scores is not None else np.zeros(len(self.tokens))
        NEG = -1e30
        best = [NEG] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        max_len = 32
        for i in range(n):
            if best[i] <= NEG:
                continue
            for j in range(i + 1, min(n, i + max_len) + 1):
                tid = self._vocab.get(s[i:j])
                if tid is None:
                    continue
                sc = best[i] + float(scores[tid])
                if sc > best[j]:
                    best[j] = sc
                    back[j] = (i, tid)
        if back[n] is None:
            # fallback: per-char with unk
            return [self.unk_id] * n if self.unk_id is not None else []
        ids: list[int] = []
        pos = n
        while pos > 0:
            i, tid = back[pos]  # type: ignore[misc]
            ids.append(tid)
            pos = i
        return list(reversed(ids))

    # -- decode --------------------------------------------------------------

    def token_bytes(self, token_id: int) -> bytes:
        """Raw bytes a token contributes to output text."""
        if token_id < 0 or token_id >= len(self.tokens):
            return b""
        t = self.tokens[token_id]
        if self.token_types is not None and token_id < len(self.token_types):
            tt = self.token_types[token_id]
            if tt == TT_BYTE:
                if len(t) == 6 and t.startswith("<0x"):
                    return bytes([int(t[3:5], 16)])
            if tt == TT_CONTROL:
                return b""
        if self.model == "gpt2":
            try:
                return bytes(_UNI_TO_BYTE[c] for c in t)
            except KeyError:
                return t.encode("utf-8")
        return t.replace(SPM_SPACE, " ").encode("utf-8")

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        out = bytearray()
        for i in ids:
            if skip_special and self.token_types is not None and \
                    0 <= i < len(self.token_types) and \
                    self.token_types[i] == TT_CONTROL:
                continue
            out.extend(self.token_bytes(int(i)))
        return out.decode("utf-8", errors="replace")

    def streaming_decoder(self) -> "StreamingDecoder":
        return StreamingDecoder(self)

    def is_eog(self, token_id: int) -> bool:
        """End-of-generation: eos or any end-of-turn token."""
        return token_id == self.eos_id or token_id in self.eot_ids


class StreamingDecoder:
    """UTF-8-safe incremental decode: buffers partial multi-byte sequences
    (parity: decode_token_streaming, reference tokenizer/mod.rs:1328)."""

    def __init__(self, tok: Tokenizer):
        self.tok = tok
        self.buf = bytearray()

    def push(self, token_id: int) -> str:
        self.buf.extend(self.tok.token_bytes(token_id))
        # emit the longest prefix that is complete UTF-8
        for cut in range(len(self.buf), max(len(self.buf) - 4, -1), -1):
            try:
                text = self.buf[:cut].decode("utf-8")
            except UnicodeDecodeError:
                continue
            del self.buf[:cut]
            return text
        return ""

    def flush(self) -> str:
        text = self.buf.decode("utf-8", errors="replace")
        self.buf.clear()
        return text
