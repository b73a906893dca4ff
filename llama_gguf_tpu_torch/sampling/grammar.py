"""Grammar-constrained sampling: GBNF / JSON / JSON-schema / regex -> token masks.

A copy of llama_gguf_tpu/sampling/grammar.py (numpy only; the port never
imports the JAX package). A character-level pushdown machine over the GBNF
grammar (sets of parse stacks, llama.cpp-style), so the token mask is exact.
JSON mode is the JSON grammar expressed in GBNF, and a JSON-Schema subset
compiles to GBNF (types, properties, enum, arrays, nullable). Regexes compile
to GBNF as well.

Masks are computed by a DFS over (vocab trie x machine state) and cached per
machine state, so repeated states during generation are free.
"""

from __future__ import annotations

import json
import re as _re
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# GBNF parsing
#
# Grammar elements (atoms) after parsing/desugaring:
#   ("char", ((lo, hi), ...), negated)  - character alternatives/ranges
#   ("ref", rule_name)                  - rule reference
# Each rule: list of alternatives; each alternative: tuple of atoms.
# Repetition  x* x+ x?  desugars into synthetic rules:
#   x*  ->  S ::= x S | eps
#   x+  ->  S ::= x S | x
#   x?  ->  S ::= x | eps
# ---------------------------------------------------------------------------


class GrammarError(ValueError):
    pass


def _char_atom(ranges: Iterable[tuple[int, int]], negated: bool = False):
    return ("char", tuple(ranges), negated)


def _match_char(atom, cp: int) -> bool:
    _, ranges, negated = atom
    hit = any(lo <= cp <= hi for lo, hi in ranges)
    return hit != negated


class _GbnfParser:
    """Recursive-descent parser for llama.cpp GBNF syntax."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rules: dict[str, list[tuple]] = {}
        self._synth = 0

    # -- lexing helpers ------------------------------------------------------

    def _skip_ws(self, newlines: bool = True) -> None:
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":  # comment to end of line
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t\r" or (newlines and c == "\n"):
                self.pos += 1
            else:
                break

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _name(self) -> str:
        m = _re.match(r"[A-Za-z][A-Za-z0-9_-]*", self.text[self.pos:])
        if not m:
            raise GrammarError(f"expected rule name at {self.pos}")
        self.pos += m.end()
        return m.group(0)

    def _expect(self, s: str) -> None:
        if not self.text.startswith(s, self.pos):
            raise GrammarError(f"expected {s!r} at {self.pos}: "
                               f"{self.text[self.pos:self.pos + 20]!r}")
        self.pos += len(s)

    # -- grammar productions -------------------------------------------------

    def parse(self) -> dict[str, list[tuple]]:
        self._skip_ws()
        while self.pos < len(self.text):
            name = self._name()
            self._skip_ws()
            self._expect("::=")
            self._skip_ws()
            alts = self._alternatives()
            self.rules.setdefault(name, []).extend(alts)
            self._skip_ws()
        if not self.rules:
            raise GrammarError("empty grammar")
        return self.rules

    def _alternatives(self) -> list[tuple]:
        alts = [self._sequence()]
        while True:
            self._skip_ws(newlines=False)
            # a '|' possibly preceded by a newline continues the rule
            save = self.pos
            self._skip_ws()
            if self._peek() == "|":
                self.pos += 1
                self._skip_ws()
                alts.append(self._sequence())
            else:
                self.pos = save
                break
        return alts

    def _sequence(self) -> tuple:
        atoms: list = []
        while True:
            self._skip_ws(newlines=False)
            c = self._peek()
            if c in ("", "|", ")", "\n"):
                break
            # lookahead: a name followed by ::= starts the next rule
            if _re.match(r"[A-Za-z]", c):
                save = self.pos
                self._name()
                self._skip_ws(newlines=False)
                nxt = self.text.startswith("::=", self.pos)
                self.pos = save
                if nxt:
                    break
                atoms.append(("ref", self._name()))
            elif c == '"':
                atoms.extend(self._literal())
            elif c == "[":
                atoms.append(self._char_class())
            elif c == "(":
                self.pos += 1
                sub = self._alternatives()
                self._skip_ws()
                self._expect(")")
                name = self._synth_rule(sub)
                atoms.append(("ref", name))
            else:
                raise GrammarError(f"unexpected char {c!r} at {self.pos}")
            # repetition suffix
            self._skip_ws(newlines=False)
            suff = self._peek()
            if suff in "*+?" and atoms:
                self.pos += 1
                atoms[-1] = ("ref", self._repeat(atoms[-1], suff))
            elif suff == "{" and atoms:
                atoms[-1] = ("ref", self._bounded_repeat(atoms[-1]))
        return tuple(atoms)

    def _literal(self) -> list:
        self._expect('"')
        out = []
        while self._peek() != '"':
            cp = self._escaped_char('"')
            out.append(_char_atom([(cp, cp)]))
        self.pos += 1
        return out

    def _char_class(self):
        self._expect("[")
        negated = self._peek() == "^"
        if negated:
            self.pos += 1
        ranges: list[tuple[int, int]] = []
        while self._peek() != "]":
            lo = self._escaped_char("]")
            hi = lo
            if self._peek() == "-" and self.text[self.pos + 1: self.pos + 2] != "]":
                self.pos += 1
                hi = self._escaped_char("]")
            ranges.append((lo, hi))
        self.pos += 1
        if not ranges and not negated:
            raise GrammarError("empty char class")
        return _char_atom(ranges, negated)

    def _escaped_char(self, terminator: str) -> int:
        c = self._peek()
        if not c:
            raise GrammarError(f"unterminated literal (expected {terminator!r})")
        self.pos += 1
        if c != "\\":
            return ord(c)
        e = self._peek()
        self.pos += 1
        table = {"n": 10, "r": 13, "t": 9, "\\": 92, '"': 34, "[": 91,
                 "]": 93, "^": 94, "-": 45, "/": 47}
        if e in table:
            return table[e]
        if e == "x":
            h = self.text[self.pos: self.pos + 2]
            self.pos += 2
            return int(h, 16)
        if e in "uU":
            n = 4 if e == "u" else 8
            h = self.text[self.pos: self.pos + n]
            self.pos += n
            return int(h, 16)
        raise GrammarError(f"bad escape \\{e}")

    # -- desugaring ----------------------------------------------------------

    def _synth_rule(self, alts: list[tuple]) -> str:
        self._synth += 1
        name = f"__g{self._synth}"
        self.rules[name] = alts
        return name

    def _repeat(self, atom, op: str) -> str:
        self._synth += 1
        name = f"__r{self._synth}"
        if op == "*":
            self.rules[name] = [(atom, ("ref", name)), ()]
        elif op == "+":
            self.rules[name] = [(atom, ("ref", name)), (atom,)]
        else:  # ?
            self.rules[name] = [(atom,), ()]
        return name

    def _bounded_repeat(self, atom) -> str:
        """{n}, {n,}, {n,m} repetition."""
        self._expect("{")
        m = _re.match(r"(\d+)(?:,(\d*))?\}", self.text[self.pos:])
        if not m:
            raise GrammarError(f"bad repetition bound at {self.pos}")
        self.pos += m.end()
        lo = int(m.group(1))
        hi = m.group(2)
        base = (atom,) * lo
        if hi is None:  # exactly n
            alts = [base]
        elif hi == "":  # n or more
            star = self._repeat(atom, "*")
            alts = [base + (("ref", star),)]
        else:
            alts = [base + (atom,) * k for k in range(int(hi) - lo + 1)]
        return self._synth_rule(alts)


# ---------------------------------------------------------------------------
# Pushdown machine: states are frozensets of parse stacks. A stack is a tuple
# of atoms still to match, top at the END (pop = stack[:-1]). The machine
# state keeps stacks normalized so every stack is empty or has a terminal
# ("char") atom on top.
# ---------------------------------------------------------------------------

_MAX_STACKS = 512  # safety valve against pathological grammars


class GbnfMachine:
    """Character-level pushdown automaton over a GBNF grammar."""

    def __init__(self, rules: dict[str, list[tuple]], root: str = "root"):
        if root not in rules:
            raise GrammarError(f"no rule named {root!r}")
        for alts in rules.values():
            for alt in alts:
                for atom in alt:
                    if atom[0] == "ref" and atom[1] not in rules:
                        raise GrammarError(f"undefined rule {atom[1]!r}")
        self.rules = rules
        self.root = root
        self._start = self._normalize(
            frozenset(tuple(reversed(alt)) for alt in rules[root])
        )

    @classmethod
    def parse(cls, text: str, root: str = "root") -> "GbnfMachine":
        return cls(_GbnfParser(text).parse(), root)

    # -- state transitions ----------------------------------------------------

    def start(self):
        return self._start

    def _normalize(self, stacks: frozenset) -> frozenset:
        """Expand refs until each stack is empty or terminal-topped."""
        out: set[tuple] = set()
        work = list(stacks)
        seen: set[tuple] = set()
        while work:
            st = work.pop()
            if st in seen:
                continue
            seen.add(st)
            if not st or st[-1][0] == "char":
                out.add(st)
                continue
            _, name = st[-1]
            base = st[:-1]
            for alt in self.rules[name]:
                work.append(base + tuple(reversed(alt)))
            if len(seen) > _MAX_STACKS:
                raise GrammarError("grammar state explosion (left recursion?)")
        return frozenset(out)

    def advance(self, state: frozenset, cp: int) -> frozenset | None:
        """Consume one codepoint; None if no stack survives."""
        nxt = set()
        for st in state:
            if st and _match_char(st[-1], cp):
                nxt.add(st[:-1])
        if not nxt:
            return None
        return self._normalize(frozenset(nxt))

    def accepting(self, state: frozenset) -> bool:
        return () in state

    def exhausted(self, state: frozenset) -> bool:
        """True when the only continuation is 'complete' (no chars allowed)."""
        return state == frozenset({()})


class RegexMachine:
    """NFA over a practical regex subset: literals, '.', classes [..]/[^..],
    \\d \\w \\s escapes, groups, '|', and * + ? {n,m} repetition.
    Implemented by compiling the regex to GBNF."""

    def __init__(self, pattern: str):
        self.pattern = pattern
        gbnf = "root ::= " + _regex_to_gbnf(pattern)
        self._m = GbnfMachine.parse(gbnf)

    def start(self):
        return self._m.start()

    def advance(self, state, cp):
        return self._m.advance(state, cp)

    def accepting(self, state):
        return self._m.accepting(state)

    def exhausted(self, state):
        return self._m.exhausted(state)


def _regex_to_gbnf(pat: str) -> str:
    """Translate a regex subset into a GBNF expression string."""
    out: list[str] = []
    i = 0
    n = len(pat)

    def esc(c: str) -> str:
        return f"[\\x{ord(c):02x}]" if c in '"[]\\^$' or ord(c) < 32 else f'"{c}"'

    CLASSES = {"d": "[0-9]", "w": "[A-Za-z0-9_]", "s": "[ \\t\\n\\r]",
               "D": "[^0-9]", "W": "[^A-Za-z0-9_]", "S": "[^ \\t\\n\\r]"}
    depth = 0
    while i < n:
        c = pat[i]
        if c == "(":
            # drop non-capturing marker
            if pat.startswith("(?:", i):
                i += 2
            out.append("(")
            depth += 1
        elif c == ")":
            out.append(")")
            depth -= 1
            if depth < 0:
                raise GrammarError("unbalanced ')' in regex")
        elif c == "|":
            out.append("|")
        elif c == ".":
            out.append("[^\\n]")
        elif c == "[":
            j = i + 1
            if j < n and pat[j] == "^":
                j += 1
            if j < n and pat[j] == "]":
                j += 1
            while j < n and pat[j] != "]":
                j += 2 if pat[j] == "\\" else 1
            if j >= n:
                raise GrammarError("unterminated char class")
            out.append(pat[i: j + 1])
            i = j
        elif c == "\\":
            i += 1
            e = pat[i] if i < n else ""
            out.append(CLASSES.get(e) or esc(e))
        elif c in "*+?":
            out.append(c)
        elif c == "{":
            j = pat.index("}", i)
            out.append(pat[i: j + 1])
            i = j
        elif c in "^$":
            pass  # anchors are implicit: the machine matches the whole string
        else:
            out.append(esc(c))
        i += 1
    if depth:
        raise GrammarError("unbalanced '(' in regex")
    return " ".join(out) if out else '""'


# ---------------------------------------------------------------------------
# JSON grammar (GBNF) + JSON-Schema subset -> GBNF
# ---------------------------------------------------------------------------

JSON_GBNF = r"""
root ::= ws value ws
value ::= object | array | string | number | "true" | "false" | "null"
object ::= "{" ws ( member ( ws "," ws member )* )? ws "}"
member ::= string ws ":" ws value
array ::= "[" ws ( value ( ws "," ws value )* )? ws "]"
string ::= "\"" char* "\""
char ::= [^"\\\x00-\x1f] | "\\" ( ["\\/bfnrt] | "u" [0-9a-fA-F]{4} )
number ::= "-"? ( "0" | [1-9] [0-9]* ) ( "." [0-9]+ )? ( [eE] [-+]? [0-9]+ )?
ws ::= [ \t\n\r]*
"""


def _gbnf_string_literal(s: str) -> str:
    body = "".join(
        {"\\": "\\\\", '"': '\\"', "\n": "\\n", "\r": "\\r", "\t": "\\t"}.get(
            c, c if 32 <= ord(c) < 127 else f"\\u{ord(c):04x}"
        )
        for c in s
    )
    return f'"{body}"'


def schema_to_gbnf(schema: dict) -> str:
    """Compile a JSON-Schema subset (type, properties/required, items, enum,
    const, anyOf/oneOf, nullable arrays of types) into a GBNF grammar."""
    rules: dict[str, str] = {}
    counter = [0]

    def visit(sc, hint: str) -> str:
        counter[0] += 1
        name = f"s{counter[0]}_{hint}"
        rules[name] = expr(sc)
        return name

    def expr(sc) -> str:
        if sc is True or sc in (None, {}):
            return "value"
        if "enum" in sc:
            return " | ".join(_json_const(v) for v in sc["enum"])
        if "const" in sc:
            return _json_const(sc["const"])
        for key in ("anyOf", "oneOf"):
            if key in sc:
                return " | ".join(f"( {expr(s)} )" for s in sc[key])
        t = sc.get("type")
        if isinstance(t, list):
            return " | ".join(f"( {expr({**sc, 'type': tt})} )" for tt in t)
        if t == "string":
            if "pattern" in sc:
                return _regex_to_gbnf(sc["pattern"].strip("^$"))
            return "string"
        if t in ("number", "integer"):
            return ("\"-\"? ( \"0\" | [1-9] [0-9]* )" if t == "integer"
                    else "number")
        if t == "boolean":
            return '"true" | "false"'
        if t == "null":
            return '"null"'
        if t == "array":
            item = sc.get("items")
            iname = visit(item, "item") if item else "value"
            lo = sc.get("minItems", 0)
            parts = [f"ws {iname}"] * lo
            tail = f'( ws "," ws {iname} )*'
            if lo == 0:
                return f'"[" ( ws {iname} {tail} )? ws "]"'
            return ('"[" ' + ' ( ws "," )? '.join(parts)
                    + f" {tail} ws \"]\"")
        if t == "object" and "properties" in sc:
            req = set(sc.get("required", sc["properties"].keys()))
            parts = []
            first = True
            for k, v in sc["properties"].items():
                vname = visit(v, _re.sub(r"[^A-Za-z0-9]", "", k)[:12] or "p")
                lit = _gbnf_string_literal(json.dumps(k))
                piece = f'ws {lit} ws ":" ws {vname}'
                if not first:
                    piece = f'ws "," {piece}'
                if k not in req:
                    piece = f"( {piece} )?"
                parts.append(piece)
                first = False
            return '"{" ' + " ".join(parts) + ' ws "}"'
        if t == "object":
            return "object"
        return "value"

    def _json_const(v) -> str:
        return _gbnf_string_literal(json.dumps(v, ensure_ascii=False))

    root_expr = expr(schema)
    lines = [f"root ::= ws ( {root_expr} ) ws"]
    lines += [f"{k} ::= {v}" for k, v in rules.items()]
    return "\n".join(lines) + "\n" + JSON_GBNF.replace(
        "root ::= ws value ws", "", 1
    )


# ---------------------------------------------------------------------------
# Grammar front-end + token-mask sampler
# ---------------------------------------------------------------------------


def json_grammar(schema: dict | str | None = None) -> GbnfMachine:
    """Free-form JSON, or schema-constrained JSON when a schema is given."""
    if schema is None:
        return GbnfMachine.parse(JSON_GBNF)
    if isinstance(schema, str):
        schema = json.loads(schema)
    return GbnfMachine.parse(schema_to_gbnf(schema))


def regex_grammar(pattern: str) -> RegexMachine:
    return RegexMachine(pattern)


def gbnf_grammar(text: str, root: str = "root") -> GbnfMachine:
    return GbnfMachine.parse(text, root)


class _TrieNode:
    __slots__ = ("children", "token_ids")

    def __init__(self):
        self.children: dict[int, _TrieNode] = {}
        self.token_ids: list[int] = []


def _build_trie(vocab: Sequence[str]) -> _TrieNode:
    root = _TrieNode()
    for tid, text in enumerate(vocab):
        if not text:
            continue
        node = root
        for ch in text:
            cp = ord(ch)
            nxt = node.children.get(cp)
            if nxt is None:
                nxt = node.children[cp] = _TrieNode()
            node = nxt
        node.token_ids.append(tid)
    return root


class GrammarSampler:
    """Per-step boolean token mask from a character grammar machine.

    mask[t] is True iff every character of token t can be consumed from the
    current machine state. Masks are cached per machine state.
    """

    def __init__(self, machine, vocab: Sequence[str],
                 eos_token_id: int | None = None):
        self.machine = machine
        self.vocab_size = len(vocab)
        self.trie = _build_trie(vocab)
        self.eos_token_id = eos_token_id
        self.state = machine.start()
        self._mask_cache: dict = {}

    def reset(self) -> None:
        self.state = self.machine.start()

    @property
    def is_complete(self) -> bool:
        return self.state is not None and self.machine.accepting(self.state)

    def get_token_mask(self) -> np.ndarray:
        if self.state is None:
            mask = np.zeros(self.vocab_size, bool)
            if self.eos_token_id is not None:
                mask[self.eos_token_id] = True
            return mask
        cached = self._mask_cache.get(self.state)
        if cached is not None:
            return cached
        mask = np.zeros(self.vocab_size, bool)
        stack = [(self.trie, self.state)]
        while stack:
            node, st = stack.pop()
            for tid in node.token_ids:
                mask[tid] = True
            for cp, child in node.children.items():
                nst = self.machine.advance(st, cp)
                if nst is not None:
                    stack.append((child, nst))
        if self.eos_token_id is not None and self.machine.accepting(self.state):
            mask[self.eos_token_id] = True
        if not mask.any() and self.eos_token_id is not None:
            mask[self.eos_token_id] = True  # dead end: allow stopping
        self._mask_cache[self.state] = mask
        return mask

    def apply_mask(self, logits: np.ndarray) -> np.ndarray:
        mask = self.get_token_mask()
        out = np.asarray(logits, np.float32).copy()
        out[~mask] = -np.inf
        return out

    def record_token(self, text: str) -> None:
        """Advance machine state by the text of the chosen token."""
        if self.state is None:
            return
        st = self.state
        for ch in text:
            st = self.machine.advance(st, ord(ch))
            if st is None:
                break
        self.state = st
