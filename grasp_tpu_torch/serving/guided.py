"""Guided (grammar-constrained) decoding for the paged serving engines
(counterpart of grasp_tpu/serving/guided.py; numpy only, this package's own
copy).

A request may carry a regex the OUTPUT must match (``guided_regex``) or ask
for JSON (``response_format``: ``json_object`` or ``json_schema``); the
engine then masks every sampling step to the tokens that keep the output
inside the grammar:

  1. a regex **subset** compiles to a byte-level NFA (Thompson construction)
     and then a DFA (subset construction). Supported: literals, ``.``,
     classes ``[a-z0-9]`` (ranges, negation), escapes ``\\d \\w \\s`` (and
     their negations), groups ``()``, alternation ``|``, repeats
     ``* + ? {m} {m,} {m,n}``.
  2. dead states (no path to an accepting state) are pruned so the mask can
     never paint the row into a corner byte-wise;
  3. the DFA lifts to the TOKEN vocabulary: ``token_trans[s, t]`` = DFA state
     after consuming token ``t``'s bytes from state ``s`` (-1 = reject),
     built with vectorized per-byte composition: O(len(token)) numpy ops of
     size S per token;
  4. at each decode step the engine masks the row's logits to
     ``token_trans[state] >= 0`` (plus eos exactly in accepting states) and
     advances the state with the picked token on the host.

Outputs: a guided row that stops on eos decodes to a string that FULLY
matches the pattern; a row cut by ``max_tokens`` matches a prefix of it.
With a byte-complete vocabulary (every byte is some token, e.g.
ByteTokenizer) a live DFA state always has an allowed token; with holey
vocabularies a starved row force-stops on eos.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# regex subset -> byte NFA (Thompson)
# ---------------------------------------------------------------------------

_CLS = {
    "d": [(48, 57)],
    "w": [(48, 57), (65, 90), (97, 122), (95, 95)],
    "s": [(9, 13), (32, 32)],
}


def _class_mask(ranges, negate=False):
    m = np.zeros(256, bool)
    for lo, hi in ranges:
        m[lo:hi + 1] = True
    return ~m if negate else m


class _Parser:
    """Recursive-descent parser for the supported regex subset -> AST.

    AST nodes: ("lit", mask256) | ("cat", [n...]) | ("alt", [n...]) |
    ("rep", node, min, max|None).
    """

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"unexpected {self.p[self.i]!r} at {self.i}")
        return node

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self.i += 1
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        items = []
        while self._peek() not in (None, "|", ")"):
            items.append(self._rep())
        if not items:
            return ("cat", [])
        return items[0] if len(items) == 1 else ("cat", items)

    def _rep(self):
        node = self._atom()
        c = self._peek()
        if c == "*":
            self.i += 1
            return ("rep", node, 0, None)
        if c == "+":
            self.i += 1
            return ("rep", node, 1, None)
        if c == "?":
            self.i += 1
            return ("rep", node, 0, 1)
        if c == "{":
            j = self.p.index("}", self.i)
            body = self.p[self.i + 1:j]
            self.i = j + 1
            if "," in body:
                lo, hi = body.split(",", 1)
                return ("rep", node, int(lo), int(hi) if hi else None)
            return ("rep", node, int(body), int(body))
        return node

    def _atom(self):
        c = self.p[self.i]
        if c == "(":
            self.i += 1
            if self.p[self.i:self.i + 2] == "?:":  # non-capturing group
                self.i += 2
            node = self._alt()
            if self._peek() != ")":
                raise ValueError("unbalanced group")
            self.i += 1
            return node
        if c == "[":
            return self._cls()
        if c == ".":
            self.i += 1
            return ("lit", _class_mask([(0, 9), (11, 255)]))  # . != \n
        if c == "\\":
            self.i += 2
            e = self.p[self.i - 1]
            if e.lower() in _CLS:
                return ("lit", _class_mask(_CLS[e.lower()], negate=e.isupper()))
            if e == "x":  # \xHH byte escape
                b = int(self.p[self.i:self.i + 2], 16)
                self.i += 2
                return ("lit", _class_mask([(b, b)]))
            if e == "n":
                return ("lit", _class_mask([(10, 10)]))
            if e == "t":
                return ("lit", _class_mask([(9, 9)]))
            if e == "r":
                return ("lit", _class_mask([(13, 13)]))
            b = e.encode("utf-8")[0]
            return ("lit", _class_mask([(b, b)]))
        self.i += 1
        bs = c.encode("utf-8")
        if len(bs) == 1:
            return ("lit", _class_mask([(bs[0], bs[0])]))
        # multi-byte literal char: a concatenation of its utf-8 bytes
        return ("cat", [("lit", _class_mask([(b, b)])) for b in bs])

    def _cls(self):
        assert self.p[self.i] == "["
        self.i += 1
        negate = self._peek() == "^"
        if negate:
            self.i += 1
        mask = np.zeros(256, bool)
        first = True
        while self._peek() != "]" or first:
            if self._peek() is None:
                raise ValueError("unterminated character class")
            first = False
            def member() -> Optional[int]:
                """One class member as a byte value; None for \\d-style sets."""
                c = self.p[self.i]
                if c == "\\":
                    e = self.p[self.i + 1]
                    self.i += 2
                    if e.lower() in _CLS:
                        nonlocal mask
                        mask |= _class_mask(_CLS[e.lower()], negate=e.isupper())
                        return None
                    if e == "x":  # \xHH byte escape
                        b = int(self.p[self.i:self.i + 2], 16)
                        self.i += 2
                        return b
                    c = {"n": "\n", "t": "\t", "r": "\r"}.get(e, e)
                else:
                    self.i += 1
                bs = c.encode("utf-8")
                if len(bs) != 1:
                    raise ValueError("non-ascii class member")
                return bs[0]

            lo = member()
            if lo is None:
                continue
            if self._peek() == "-" and self.p[self.i + 1] != "]":
                self.i += 1
                hi = member()
                if hi is None:
                    raise ValueError("bad class range")
                mask |= _class_mask([(lo, hi)])
            else:
                mask[lo] = True
        self.i += 1
        return ("lit", ~mask if negate else mask)


class _NFA:
    """Thompson NFA: integer states, eps edges, byte-mask edges."""

    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[np.ndarray, int]]] = []

    def new(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node) -> Tuple[int, int]:
        kind = node[0]
        if kind == "lit":
            s, t = self.new(), self.new()
            self.edges[s].append((node[1], t))
            return s, t
        if kind == "cat":
            s = t = self.new()
            for child in node[1]:
                cs, ct = self.build(child)
                self.eps[t].append(cs)
                t = ct
            return s, t
        if kind == "alt":
            s, t = self.new(), self.new()
            for child in node[1]:
                cs, ct = self.build(child)
                self.eps[s].append(cs)
                self.eps[ct].append(t)
            return s, t
        if kind == "rep":
            _, child, lo, hi = node
            s = t = self.new()
            for _ in range(lo):  # mandatory copies
                cs, ct = self.build(child)
                self.eps[t].append(cs)
                t = ct
            if hi is None:  # unbounded tail: loop
                cs, ct = self.build(child)
                self.eps[t].append(cs)
                self.eps[ct].append(t)  # may be skipped entirely
            else:
                for _ in range(hi - lo):  # optional copies
                    cs, ct = self.build(child)
                    end = self.new()
                    self.eps[t].append(cs)
                    self.eps[t].append(end)
                    self.eps[ct].append(end)
                    t = end
            return s, t
        raise AssertionError(kind)


def _dfa_of(pattern: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """(trans [S, 256] int32 with -1 = reject, accepting [S] bool, start).

    Dead states (no path to acceptance) are pruned to -1 so a masked decode
    can never enter a state it cannot finish from."""
    nfa = _NFA()
    s0, acc = nfa.build(_Parser(pattern).parse())

    def closure(states) -> frozenset:
        seen, stack = set(states), list(states)
        while stack:
            for nxt in nfa.eps[stack.pop()]:
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return frozenset(seen)

    start = closure([s0])
    index = {start: 0}
    order = [start]
    rows: List[np.ndarray] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        # per-byte move: union of targets whose mask covers the byte
        movers = [(m, t) for st in cur for (m, t) in nfa.edges[st]]
        row = np.full(256, -1, np.int64)
        if movers:
            byte_targets: List[set] = [set() for _ in range(256)]
            for m, t in movers:
                for b in np.nonzero(m)[0]:
                    byte_targets[b].add(t)
            cache: Dict[frozenset, int] = {}
            for b in range(256):
                if not byte_targets[b]:
                    continue
                key = frozenset(byte_targets[b])
                if key not in cache:
                    cl = closure(key)
                    if cl not in index:
                        index[cl] = len(order)
                        order.append(cl)
                    cache[key] = index[cl]
                row[b] = cache[key]
        rows.append(row)
    trans = np.stack(rows).astype(np.int32)
    accepting = np.array([acc in st for st in order], bool)

    # prune dead states: reverse-reachability from accepting states
    S = len(order)
    live = accepting.copy()
    changed = True
    while changed:
        changed = False
        reaches = live[np.where(trans >= 0, trans, 0)] & (trans >= 0)
        new_live = live | reaches.any(axis=1)
        changed = bool((new_live != live).any())
        live = new_live
    dead = ~live
    if dead[0]:
        raise ValueError(f"pattern {pattern!r} matches nothing")
    trans[dead[np.where(trans >= 0, trans, 0)] & (trans >= 0)] = -1
    return trans, accepting, 0


class CompiledGrammar:
    """A byte DFA lifted to a token vocabulary.

    allowed[s] ([V] bool) masks the sampler; token_trans[s, t] advances the
    state. eos handling is the ENGINE's: allow eos iff accepting[state]."""

    def __init__(self, pattern: str, token_bytes: List[Optional[bytes]]):
        self.pattern = pattern
        trans, self.accepting, self.start = _dfa_of(pattern)
        self.n_states = trans.shape[0]
        V = len(token_bytes)
        # lift per byte: start from the state ids, compose the byte maps of
        # the token's bytes (O(len) vector ops of size S per token)
        self.token_trans = np.full((self.n_states, V), -1, np.int32)
        state_ids = np.arange(self.n_states, dtype=np.int32)
        for t, bs in enumerate(token_bytes):
            if not bs:
                continue
            cur = state_ids
            for b in bs:
                nxt = trans[np.maximum(cur, 0), b]
                cur = np.where(cur >= 0, nxt, -1).astype(np.int32)
            self.token_trans[:, t] = cur
        self.allowed = self.token_trans >= 0


def token_bytes_of(tokenizer, vocab_size: int) -> List[Optional[bytes]]:
    """Best-effort token id -> byte string. None marks special/unusable ids.

    ByteTokenizer: exact (ids 0-255 ARE bytes). HF fast tokenizers: each id
    decodes alone — right for byte-level BPE, approximate for sentencepiece
    models whose piece text depends on context (documented limitation)."""
    out: List[Optional[bytes]] = [None] * vocab_size
    if type(tokenizer).__name__ == "ByteTokenizer":
        for i in range(256):
            out[i] = bytes([i])
        return out
    specials = {getattr(tokenizer, n, None) for n in
                ("bos_token_id", "eos_token_id", "pad_token_id", "unk_token_id")}
    for i in range(min(vocab_size, getattr(tokenizer, "vocab_size", vocab_size))):
        if i in specials:
            continue
        try:
            s = tokenizer.decode([i], skip_special_tokens=False)
        except Exception:
            continue
        if s:
            out[i] = s.encode("utf-8", errors="replace")
    return out


_RE_SPECIALS = set('.[](){}*+?|\\"^$-')


def _lit(text: str) -> str:
    """Escape a literal string for the regex subset (ascii assumed)."""
    return "".join("\\" + c if c in _RE_SPECIALS else c for c in text)


_WS = r"[ \n\t\r]*"
_STRING = r'"([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})*"'
_INTEGER = r"-?(0|[1-9][0-9]{0,15})"
_NUMBER = _INTEGER + r"(\.[0-9]{1,15})?([eE][+-]?[0-9]{1,3})?"


def schema_regex(schema: dict) -> str:
    """Compile a JSON Schema (practical subset) to a regex the guided
    decoder enforces — the Outlines approach, self-contained.

    Supported: ``type`` object (properties emitted in DECLARATION order —
    a DFA cannot track the k! orderings; optional properties stay optional
    in that order), string (+ ``enum``/``const``/``pattern``), integer,
    number, boolean, null, array (``items`` + ``minItems``/``maxItems``),
    and ``enum``/``anyOf``/``oneOf`` alternation at any level. Unsupported
    keywords raise ValueError (never silently ignored: the output would
    falsely claim schema conformance). ``$ref``/unbounded recursion is
    unsupported — a DFA cannot count nesting."""

    def value(s) -> str:
        if not isinstance(s, dict):
            raise ValueError(f"schema node must be an object, got {s!r}")
        if "enum" in s:
            return "(" + "|".join(_scalar(v) for v in s["enum"]) + ")"
        if "const" in s:
            return _scalar(s["const"])
        alts = s.get("anyOf") or s.get("oneOf")
        if alts:
            return "(" + "|".join(value(a) for a in alts) + ")"
        t = s.get("type")
        if isinstance(t, list):
            return "(" + "|".join(value({**s, "type": x}) for x in t) + ")"
        if t == "object":
            return _object(s)
        if t == "array":
            return _array(s)
        if t == "string":
            if "pattern" in s:  # anchored, like JSON Schema semantics
                return f'"({s["pattern"]})"'
            return _STRING
        if t == "integer":
            return _INTEGER
        if t == "number":
            return _NUMBER
        if t == "boolean":
            return "(true|false)"
        if t == "null":
            return "null"
        raise ValueError(f"unsupported schema: {s!r}")

    def _scalar(v) -> str:
        if isinstance(v, str):
            return '"' + _lit(v) + '"'
        if v is True:
            return "true"
        if v is False:
            return "false"
        if v is None:
            return "null"
        if isinstance(v, (int, float)):
            return _lit(json.dumps(v))
        raise ValueError(f"unsupported enum/const value: {v!r}")

    def _object(s) -> str:
        props = s.get("properties", {})
        required = set(s.get("required", props.keys()))
        unknown = required - set(props)
        if unknown:
            raise ValueError(f"required names missing from properties: {unknown}")
        if not props:
            return r"\{" + _WS + r"\}"
        parts = []
        for name, sub in props.items():  # dict order == declaration order
            pair = f'{_WS}"{_lit(name)}"{_WS}:{_WS}{value(sub)}'
            parts.append((pair, name in required))
        # fixed declaration order; commas exactly between EMITTED pairs:
        # alternate over which property is emitted FIRST (any optional
        # prefix may be skipped, never past a required property), then the
        # rest follow with `(,pair)?` for optional and `,pair` for required
        alts = []
        for i, (pair, req) in enumerate(parts):
            # pair i is the FIRST emitted: properties before i were skipped
            # (all optional), the tail continues from i+1
            t = ""
            for p2, r2 in reversed(parts[i + 1:]):
                seg = f"{_WS},{p2}"
                t = seg + t if r2 else f"({seg})?{t}"
            alts.append(pair + t)
            if req:
                break  # a required pair cannot be skipped
        body = "(" + "|".join(alts) + ")"
        if not any(req for _, req in parts):
            body = f"({body})?"  # entirely optional object may be {}
        return r"\{" + body + _WS + r"\}"

    def _array(s) -> str:
        item = value(s.get("items", {"type": "string"}))
        lo = int(s.get("minItems", 0))
        hi = s.get("maxItems")
        one = f"{_WS}{item}"
        sep = f"{_WS},{_WS}{item}"
        if hi is not None:
            hi = int(hi)
            if hi < lo:
                raise ValueError("maxItems < minItems")
            if hi == 0:
                return r"\[" + _WS + r"\]"
            more = (f"({sep}){{{max(lo - 1, 0)},{hi - 1}}}" if lo > 1
                    else f"({sep}){{0,{hi - 1}}}")
            body = f"{one}{more}"
        else:
            more = f"({sep})*" if lo <= 1 else f"({sep}){{{lo - 1},}}"
            body = f"{one}{more}"
        if lo == 0:
            body = f"({body})?"
        return r"\[" + body + _WS + r"\]"

    return value(schema)


def json_regex(max_depth: int = 2) -> str:
    """Regex for a JSON value with nesting bounded at `max_depth` (objects/
    arrays deeper than that are excluded — a DFA cannot count brackets)."""
    ws = r"[ \n\t\r]*"
    string = r'"([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})*"'
    number = r"-?(0|[1-9][0-9]{0,15})(\.[0-9]{1,15})?([eE][+-]?[0-9]{1,3})?"
    value = f"({string}|{number}|true|false|null)"
    for _ in range(max_depth):
        pair = f"{ws}{string}{ws}:{ws}{value}"
        obj = f"\\{{({pair}({ws},{pair})*)?{ws}\\}}"
        arr = f"\\[({ws}{value}({ws},{ws}{value})*{ws}|{ws})\\]"
        value = f"({string}|{number}|true|false|null|{obj}|{arr})"
    return value
