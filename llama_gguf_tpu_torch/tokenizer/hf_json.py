"""HF tokenizer.json loading, without the `tokenizers` package (port of
llama_gguf_tpu/tokenizer/hf_json.py; the same ids and text on every file).

  models          BPE (vocab + merges, byte-level or byte-fallback),
                  Unigram (Viterbi over [token, score] vocab),
                  WordPiece (greedy longest-match with "##" continuation)
  normalizers     NFC/NFD/NFKC/NFKD, Lowercase, Prepend, Replace, Strip,
                  Sequence, BertNormalizer (lowercase+clean), Precompiled->NFC
  pre-tokenizers  ByteLevel (GPT-2 regex + byte->unicode, add_prefix_space),
                  Whitespace, Metaspace, Punctuation/BertPreTokenizer,
                  Digits, Split (regex), Sequence
  post-processor  TemplateProcessing "single" template (bos/eos placement),
                  special-token id sniffing
  added_tokens    split out before tokenization; special flags honored

The byte tables and the GPT-2 pattern come from the port's own
gguf_tokenizer.py. Without the `regex` package the GPT-2 pattern is absent
(ByteLevel then takes each piece whole) and Split patterns compile with `re`.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Any, Iterable

from .gguf_tokenizer import _BYTE_TO_UNI, _UNI_TO_BYTE, _GPT2_PAT, _rx

SPM_SPACE = "▁"


# ---------------------------------------------------------------------------
# normalizers
# ---------------------------------------------------------------------------


def _parse_normalizer(cfg: dict | None):
    """Config -> fn(text) -> text."""
    if not cfg:
        return None
    t = cfg.get("type")
    if t in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s, _f=t: unicodedata.normalize(_f, s)
    if t == "Precompiled":  # SPM precompiled charsmap ~ NFC for our purposes
        return lambda s: unicodedata.normalize("NFC", s)
    if t == "Lowercase":
        return str.lower
    if t == "Strip":
        left = cfg.get("strip_left", cfg.get("left", True))
        right = cfg.get("strip_right", cfg.get("right", True))

        def strip(s):
            if left:
                s = s.lstrip()
            if right:
                s = s.rstrip()
            return s
        return strip
    if t == "Prepend":
        p = cfg.get("prepend", "")
        # HF prepends unconditionally (even when the text already starts
        # with the string)
        return lambda s: (p + s) if s else s
    if t == "Replace":
        pat = cfg.get("pattern", {})
        content = cfg.get("content", "")
        if "String" in pat:
            lit = pat["String"]
            return lambda s: s.replace(lit, content)
        if "Regex" in pat:
            creg = re.compile(pat["Regex"])
            return lambda s: creg.sub(content, s)
        return None
    if t == "BertNormalizer":
        lower = cfg.get("lowercase", True)

        def bert_norm(s):
            s = "".join(" " if c in "\t\n\r" else c for c in s
                        if unicodedata.category(c) != "Cc" or c in "\t\n\r")
            return s.lower() if lower else s
        return bert_norm
    if t == "Sequence":
        fns = [f for f in (_parse_normalizer(c)
                           for c in cfg.get("normalizers", [])) if f]

        def seq(s):
            for f in fns:
                s = f(s)
            return s
        return seq
    return None


# ---------------------------------------------------------------------------
# pre-tokenizers: fn(text) -> list[str] pieces (model units)
# ---------------------------------------------------------------------------


_WS_PAT = re.compile(r"\w+|[^\w\s]+")
_PUNCT_PAT = re.compile(r"\w+|[^\w\s]")


def _parse_pre_tokenizer(cfg: dict | None):
    """Config -> (fn(text) -> list[str], byte_level: bool)."""
    if not cfg:
        return None, False
    t = cfg.get("type")
    if t == "ByteLevel":
        add_prefix = cfg.get("add_prefix_space", True)
        use_regex = cfg.get("use_regex", True)

        def bl(s):
            if add_prefix and s and not s.startswith(" "):
                s = " " + s
            words = _GPT2_PAT.findall(s) if (use_regex and _GPT2_PAT) else [s]
            return ["".join(_BYTE_TO_UNI[b] for b in w.encode("utf-8"))
                    for w in words]
        return bl, True
    if t in ("Whitespace", "WhitespaceSplit"):
        if t == "WhitespaceSplit":
            return (lambda s: s.split()), False
        return (lambda s: _WS_PAT.findall(s)), False
    if t == "Metaspace":
        rep = cfg.get("replacement", SPM_SPACE) or SPM_SPACE
        add_prefix = cfg.get("add_prefix_space", True)
        if isinstance(cfg.get("prepend_scheme"), str):
            add_prefix = cfg["prepend_scheme"] in ("always", "first")

        def ms(s):
            if add_prefix and s and not s.startswith(" "):
                s = " " + s
            return [s.replace(" ", rep)] if s else []
        return ms, False
    if t in ("Punctuation", "BertPreTokenizer"):
        return (lambda s: _PUNCT_PAT.findall(s)), False
    if t == "Digits":
        if cfg.get("individual_digits", False):
            pat = re.compile(r"\d|\D+")
        else:
            pat = re.compile(r"\d+|\D+")
        return (lambda s: pat.findall(s)), False
    if t == "Split":
        p = cfg.get("pattern", {})
        regex = p.get("Regex") or (re.escape(p["String"]) if "String" in p
                                   else None)
        if regex is None:
            return None, False
        eng = _rx if _rx is not None else re
        creg = eng.compile(regex)
        invert = cfg.get("invert", False)
        behavior = cfg.get("behavior", "Removed")

        def split(s):
            if invert or behavior == "Isolated":
                out, last = [], 0
                for m in creg.finditer(s):
                    if m.start() > last:
                        out.append(s[last: m.start()])
                    out.append(m.group(0))
                    last = m.end()
                if last < len(s):
                    out.append(s[last:])
                return [p for p in out if p]
            return [p for p in creg.split(s) if p]
        return split, False
    if t == "Sequence":
        parsed = [_parse_pre_tokenizer(c)
                  for c in cfg.get("pretokenizers", [])]
        fns = [f for f, _ in parsed if f]
        byte_level = any(bl for _, bl in parsed)

        def seq(s):
            pieces = [s]
            for f in fns:
                nxt = []
                for p in pieces:
                    nxt.extend(f(p))
                pieces = nxt
            return pieces
        return (seq if fns else None), byte_level
    return None, False


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------


class HFTokenizer:
    """Self-contained tokenizer.json engine with the GGUF Tokenizer's
    surface (encode/decode/token_bytes/streaming_decoder/is_eog)."""

    def __init__(self, path: str):
        with open(path) as f:
            root = json.load(f)
        self._load(root)
        # sniff chat template / add_bos from tokenizer_config.json
        self.chat_template = None
        cfgp = os.path.join(os.path.dirname(path), "tokenizer_config.json")
        if os.path.exists(cfgp):
            with open(cfgp) as f:
                cfg = json.load(f)
            self.chat_template = cfg.get("chat_template")
            for key, attr in (("bos_token", "bos_id"), ("eos_token", "eos_id")):
                v = cfg.get(key)
                if isinstance(v, dict):
                    v = v.get("content")
                if isinstance(v, str) and v in self._vocab:
                    setattr(self, attr, self._vocab[v])
            if "add_bos_token" in cfg:
                self.add_bos = bool(cfg["add_bos_token"])
        self.eot_ids = (self.eos_id,) if self.eos_id is not None else ()

    # -- parsing -------------------------------------------------------------

    def _load(self, root: dict) -> None:
        model = root.get("model") or {}
        self.model_type = model.get("type", "BPE")
        self._vocab: dict[str, int] = {}
        self.tokens: list[str] = []
        self._scores: dict[str, float] = {}
        self._merge_ranks: dict[tuple[str, str], int] = {}
        self._wp_prefix = model.get("continuing_subword_prefix", "##")
        self._bpe_cache: dict[str, list[int]] = {}
        self.unk_id = None
        self.bos_id = None
        self.eos_id = None
        self.add_bos = False
        self.add_eos = False

        if self.model_type == "Unigram":
            vocab = model.get("vocab") or []
            for i, entry in enumerate(vocab):
                tok, score = entry[0], float(entry[1]) if len(entry) > 1 else 0.0
                self._vocab[tok] = i
                self.tokens.append(tok)
                self._scores[tok] = score
            if model.get("unk_id") is not None:
                self.unk_id = int(model["unk_id"])
        else:  # BPE / WordPiece: vocab is {token: id}
            vocab = model.get("vocab") or {}
            size = max(vocab.values(), default=-1) + 1
            self.tokens = [""] * size
            for tok, i in vocab.items():
                self._vocab[tok] = int(i)
                if 0 <= int(i) < size:
                    self.tokens[int(i)] = tok
            for rank, m in enumerate(model.get("merges") or []):
                parts = m.split(" ") if isinstance(m, str) else list(m)
                if len(parts) == 2:
                    self._merge_ranks[(parts[0], parts[1])] = rank
            unk = model.get("unk_token")
            if unk and unk in self._vocab:
                self.unk_id = self._vocab[unk]

        # added tokens: appended to the vocab, split out before the model
        self._special: dict[str, int] = {}
        for tobj in root.get("added_tokens") or []:
            content, tid = tobj.get("content"), int(tobj.get("id", -1))
            if content is None or tid < 0:
                continue
            if tid >= len(self.tokens):
                self.tokens.extend([""] * (tid + 1 - len(self.tokens)))
            self.tokens[tid] = content
            self._vocab.setdefault(content, tid)
            if tobj.get("special", False):
                self._special[content] = tid
                low = content.lower()
                if "<s>" == content or "begin_of_text" in low or low == "<|startoftext|>":
                    self.bos_id = tid
                elif content == "</s>" or "end_of_text" in low or low == "<|endoftext|>":
                    if self.eos_id is None:
                        self.eos_id = tid
                elif content == "[UNK]" and self.unk_id is None:
                    self.unk_id = tid
        self._special_re = None
        if self._special:
            pat = "|".join(re.escape(t) for t in
                           sorted(self._special, key=len, reverse=True))
            self._special_re = re.compile(f"({pat})")

        self._normalize = _parse_normalizer(root.get("normalizer"))
        self._pre, self._byte_level = _parse_pre_tokenizer(
            root.get("pre_tokenizer"))
        # decode needs to know whether a leading space was synthesized
        # (Metaspace add_prefix_space / Prepend normalizer)
        def _prefixes_space(cfg) -> bool:
            if not isinstance(cfg, dict):
                return False
            t = cfg.get("type")
            if t == "Metaspace":
                scheme = cfg.get("prepend_scheme")
                if isinstance(scheme, str):
                    return scheme in ("always", "first")
                return bool(cfg.get("add_prefix_space", True))
            if t == "Prepend":
                return cfg.get("prepend", "") in (SPM_SPACE, " ")
            subs = cfg.get("pretokenizers") or cfg.get("normalizers") or []
            return any(_prefixes_space(c) for c in subs)

        self._strip_leading_space = (
            _prefixes_space(root.get("pre_tokenizer"))
            or _prefixes_space(root.get("normalizer")))
        if self._pre is None:
            # no pre-tokenizer: the whole text is one model unit (SPM-style)
            self._pre = lambda s: [s] if s else []

        # post-processor: TemplateProcessing single template -> bos/eos.
        # Llama-3-style files nest it inside a Sequence processor
        # (ByteLevel + TemplateProcessing) — find it recursively.
        self._template: list[tuple[str, int | None]] = []
        post = root.get("post_processor") or {}
        if post.get("type") == "Sequence":
            for sub in post.get("processors") or []:
                if isinstance(sub, dict) and \
                        sub.get("type") == "TemplateProcessing":
                    post = sub
                    break
        if post.get("type") == "TemplateProcessing":
            for item in post.get("single") or []:
                if "SpecialToken" in item:
                    name = item["SpecialToken"].get("id")
                    tid = self._vocab.get(name)
                    if tid is not None:
                        self._template.append(("special", tid))
                elif "Sequence" in item:
                    self._template.append(("sequence", None))
            for name, obj in (post.get("special_tokens") or {}).items():
                ids = obj.get("ids") or []
                low = name.lower()
                if ids and ("<s>" == name or "begin_of_text" in low):
                    self.bos_id = int(ids[0])
                if ids and (name == "</s>" or "end_of_text" in low):
                    self.eos_id = int(ids[0])
        # template implies which specials wrap the sequence
        if self._template:
            seq_at = [i for i, (k, _) in enumerate(self._template)
                      if k == "sequence"]
            if seq_at:
                before = [tid for k, tid in self._template[:seq_at[0]]
                          if k == "special"]
                if before:
                    self.add_bos = True
                    if self.bos_id is None:
                        self.bos_id = before[0]
                after = [tid for k, tid in self._template[seq_at[-1] + 1:]
                         if k == "special"]
                if after:
                    self.add_eos = True
                    if self.eos_id is None:
                        self.eos_id = after[-1]

        # byte-fallback tokens <0xNN> (SPM-style BPE/Unigram)
        self._byte_tokens: dict[int, int] = {}
        for i, t in enumerate(self.tokens):
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                try:
                    self._byte_tokens[int(t[3:5], 16)] = i
                except ValueError:
                    pass

    # -- encoding ------------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def encode(self, text: str, add_bos: bool | None = None,
               add_special: bool = True, parse_special: bool = True) -> list[int]:
        ids: list[int] = []
        segments: list[tuple[str, bool]] = []
        if parse_special and self._special_re is not None:
            for part in self._special_re.split(text):
                if part:
                    segments.append((part, part in self._special))
        else:
            segments.append((text, False))
        for seg, is_special in segments:
            if is_special:
                ids.append(self._special[seg])
                continue
            if self._normalize is not None:
                seg = self._normalize(seg)
            for piece in self._pre(seg):
                ids.extend(self._encode_piece(piece))
        use_bos = self.add_bos if add_bos is None else add_bos
        if add_special and use_bos and self.bos_id is not None and \
                (not ids or ids[0] != self.bos_id):
            # guard against double-BOS when the prompt already starts with
            # the BOS token (chat templates commonly include it literally)
            ids.insert(0, self.bos_id)
        if add_special and self.add_eos and self.eos_id is not None:
            ids.append(self.eos_id)
        return ids

    def _encode_piece(self, piece: str) -> list[int]:
        if not piece:
            return []
        if self.model_type == "Unigram":
            return self._unigram(piece)
        if self.model_type == "WordPiece":
            return self._wordpiece(piece)
        return self._bpe(piece)

    def _bpe(self, word: str) -> list[int]:
        # per-piece memoization: pre-tokenized words repeat heavily
        cached = self._bpe_cache.get(word)
        if cached is not None:
            return cached
        out = self._bpe_uncached(word)
        if len(word) <= 32 and len(self._bpe_cache) < 1 << 16:
            self._bpe_cache[word] = out
        return out

    def _bpe_uncached(self, word: str) -> list[int]:
        """Heap-based BPE over a doubly-linked symbol list: O(n log n)
        instead of a full pair rescan per merge — matters for SPM-style
        files with a null pre-tokenizer, where the whole text is one
        piece."""
        import heapq

        n = len(word)
        if n == 0:
            return []
        sym = list(word)           # symbol strings (merged spans)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        alive = [True] * n
        ranks = self._merge_ranks
        heap: list[tuple[int, int, int]] = []  # (rank, left_idx, version)
        version = [0] * n

        def push(i):
            j = nxt[i]
            if i < 0 or j < 0:
                return
            r = ranks.get((sym[i], sym[j]))
            if r is not None:
                heapq.heappush(heap, (r, i, version[i]))

        for i in range(n - 1):
            push(i)
        while heap:
            r, i, ver = heapq.heappop(heap)
            if not alive[i] or ver != version[i]:
                continue
            j = nxt[i]
            if j < 0 or not alive[j]:
                continue
            if ranks.get((sym[i], sym[j])) != r:
                continue
            sym[i] = sym[i] + sym[j]
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prev[nxt[j]] = i
            version[i] += 1
            push(i)
            if prev[i] >= 0:
                version[prev[i]] += 1
                push(prev[i])
        out = []
        i = 0
        while i >= 0:
            if alive[i]:
                tid = self._vocab.get(sym[i])
                if tid is not None:
                    out.append(tid)
                else:
                    out.extend(self._fallback_bytes(sym[i]))
            i = nxt[i]
        return out

    def _unigram(self, text: str) -> list[int]:
        n = len(text)
        NEG = -1e30
        best = [NEG] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        max_len = max((len(t) for t in self._scores), default=1)
        for end in range(1, n + 1):
            for start in range(max(0, end - max_len), end):
                if best[start] <= NEG:
                    continue
                sub = text[start:end]
                tid = self._vocab.get(sub)
                if tid is None or sub not in self._scores:
                    continue
                score = best[start] + self._scores[sub]
                if score > best[end]:
                    best[end] = score
                    back[end] = (start, tid)
        if best[n] <= NEG:  # no full segmentation: per-char with fallback
            out = []
            for ch in text:
                tid = self._vocab.get(ch)
                out.extend([tid] if tid is not None
                           else self._fallback_bytes(ch))
            return out
        out = []
        end = n
        while end > 0:
            start, tid = back[end]
            out.append(tid)
            end = start
        return out[::-1]

    def _wordpiece(self, word: str) -> list[int]:
        out = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while end > start:
                sub = word[start:end]
                if start > 0:
                    sub = self._wp_prefix + sub
                if sub in self._vocab:
                    cur = self._vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id] if self.unk_id is not None else []
            out.append(cur)
            start = end
        return out

    def _fallback_bytes(self, s: str) -> list[int]:
        out = []
        for b in s.encode("utf-8"):
            tid = self._byte_tokens.get(b)
            if tid is not None:
                out.append(tid)
            elif self.unk_id is not None:
                out.append(self.unk_id)
        return out

    # -- decoding ------------------------------------------------------------

    def token_bytes(self, token_id: int) -> bytes:
        if not (0 <= token_id < len(self.tokens)):
            return b""
        t = self.tokens[token_id]
        if token_id in self._special.values():
            return t.encode("utf-8")
        if self._byte_level:
            return bytes(_UNI_TO_BYTE.get(c, ord(" ")) for c in t)
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                return bytes([int(t[3:5], 16)])
            except ValueError:
                return t.encode("utf-8")
        return t.replace(SPM_SPACE, " ").encode("utf-8")

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        special_ids = set(self._special.values())
        if self.model_type == "WordPiece":
            # space-join words; "##" continuations attach to the previous
            parts: list[str] = []
            for i in ids:
                if skip_special and i in special_ids:
                    continue
                t = self.tokens[i] if 0 <= i < len(self.tokens) else ""
                if t.startswith(self._wp_prefix) and parts:
                    parts[-1] += t[len(self._wp_prefix):]
                else:
                    parts.append(t)
            return " ".join(parts)
        out = bytearray()
        for i in ids:
            if skip_special and i in special_ids:
                continue
            out += self.token_bytes(i)
        text = out.decode("utf-8", errors="replace")
        if self._strip_leading_space and text.startswith(" "):
            text = text[1:]
        return text

    def streaming_decoder(self):
        from .gguf_tokenizer import StreamingDecoder

        return StreamingDecoder(self)  # type: ignore[arg-type]

    def is_eog(self, token_id: int) -> bool:
        return token_id == self.eos_id or token_id in self.eot_ids
