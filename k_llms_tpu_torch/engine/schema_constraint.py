"""Schema-guided decoding: compile a JSON Schema (pydantic
``model_json_schema()``) into a byte-level DFA enforced as a logit mask.

Where ``json_constraint`` guarantees syntactic JSON, this guarantees the
SCHEMA: object keys in order, value types, enum literals, array structure —
so every sample of a ``parse()`` request validates into the user's pydantic
model (the guarantee the reference delegates to OpenAI's structured outputs,
`k_llms/resources/completions/completions.py:134`).

Because object keys are literal text, the compiled automaton needs no stack:
nesting unrolls into the state chain at compile time. Each schema compiles to
dense ``trans[S, 256]`` tables (a few hundred states for typical extraction
schemas); the decode loop indexes them exactly like the generic JSON tables.

Supported: objects (nested, all properties emitted in schema order), string
(plus ``minLength``/``maxLength`` character bounds and the ``date``/``time``/
``uuid`` formats), integer, number, boolean, null, Optional/anyOf unions with
distinct first bytes, string enums (compiled to a shared-prefix trie), arrays
of any supported element, and const. Unsupported constructs raise
``SchemaUnsupported`` — the caller falls back to the generic JSON automaton.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

_DIGITS = list(range(0x30, 0x3A))


class SchemaUnsupported(Exception):
    """Schema uses a construct the DFA compiler does not cover."""


class SchemaDFA(NamedTuple):
    trans: np.ndarray    # [S, 256] int32 next state or -1
    terminal: np.ndarray  # [S] bool — EOS permitted here
    start: int
    digest: str          # cache key for jit reuse


class _Builder:
    def __init__(self) -> None:
        self.trans: List[Dict[int, int]] = []

    def new_state(self) -> int:
        self.trans.append({})
        return len(self.trans) - 1

    def edge(self, src: int, byte: int, dst: int) -> None:
        existing = self.trans[src].get(byte)
        if existing is not None and existing != dst:
            raise SchemaUnsupported(
                f"ambiguous transition on byte {byte!r} (union arms must start "
                "with distinct bytes)"
            )
        self.trans[src][byte] = dst

    def literal(self, src: int, data: bytes) -> int:
        """Chain of single-byte states consuming ``data``; returns the end state."""
        cur = src
        for b in data:
            nxt = self.new_state()
            self.edge(cur, b, nxt)
            cur = nxt
        return cur

    # -- value builders: each wires src -> (accepting) end state ----------

    def string_body(self, src: int) -> int:
        """Content of a string AFTER the opening quote, through the closing
        quote. Escapes and \\uXXXX supported; control bytes excluded; multibyte
        sequences are constrained to WELL-FORMED UTF-8 (JSON documents must be
        valid UTF-8, and json.loads rejects stray continuation bytes)."""
        body = self.new_state()
        esc = self.new_state()
        end = self.new_state()
        c1 = self.new_state()  # expect 1 continuation byte
        c2 = self.new_state()  # expect 2
        c3 = self.new_state()  # expect 3
        e0 = self.new_state()  # E0: next in A0..BF
        ed = self.new_state()  # ED: next in 80..9F (no surrogates)
        f0 = self.new_state()  # F0: next in 90..BF
        f4 = self.new_state()  # F4: next in 80..8F (<= U+10FFFF)
        for state in (src, body):
            for b in range(0x20, 0x80):
                if b not in (0x22, 0x5C):  # '"' and '\\'
                    self.edge(state, b, body)
            self.edge(state, 0x22, end)
            self.edge(state, 0x5C, esc)
            for b in range(0xC2, 0xE0):
                self.edge(state, b, c1)
            self.edge(state, 0xE0, e0)
            for b in [*range(0xE1, 0xED), 0xEE, 0xEF]:
                self.edge(state, b, c2)
            self.edge(state, 0xED, ed)
            self.edge(state, 0xF0, f0)
            for b in range(0xF1, 0xF4):
                self.edge(state, b, c3)
            self.edge(state, 0xF4, f4)
        for b in range(0x80, 0xC0):
            self.edge(c1, b, body)
            self.edge(c2, b, c1)
            self.edge(c3, b, c2)
        for b in range(0xA0, 0xC0):
            self.edge(e0, b, c1)
        for b in range(0x80, 0xA0):
            self.edge(ed, b, c1)
        for b in range(0x90, 0xC0):
            self.edge(f0, b, c2)
        for b in range(0x80, 0x90):
            self.edge(f4, b, c2)
        for b in b'"\\/bfnrt':
            self.edge(esc, b, body)
        self._u_escape(esc, body)
        return end

    _HEX = b"0123456789abcdefABCDEF"

    def _u_escape(self, esc: int, dst: int) -> None:
        """``\\uXXXX`` from an escape state, with surrogate hygiene: a lone
        surrogate is banned (json.loads tolerates one, but the decoded string
        is unpaired UTF-16 that pydantic — and any strict consumer — rejects);
        a high surrogate must be completed by a low-surrogate escape, and the
        whole pair lands on ``dst`` as one character."""
        u0 = self.new_state()
        self.edge(esc, ord("u"), u0)
        u1 = self.new_state()  # first digit not d/D: plain BMP escape
        s1 = self.new_state()  # first digit d/D: maybe a surrogate
        u2 = self.new_state()
        u3 = self.new_state()
        for b in self._HEX:
            self.edge(u0, b, s1 if b in b"dD" else u1)
            self.edge(u1, b, u2)
            self.edge(u2, b, u3)
            self.edge(u3, b, dst)
        for b in b"01234567":  # D0xx-D7xx: still BMP
            self.edge(s1, b, u2)
        # D8xx-DBxx: high surrogate — the low half is mandatory.
        h2, h3 = self.new_state(), self.new_state()
        p_bs, p_u = self.new_state(), self.new_state()
        p0, p1, p2, p3 = (self.new_state() for _ in range(4))
        for b in b"89abAB":
            self.edge(s1, b, h2)
        for b in self._HEX:
            self.edge(h2, b, h3)
            self.edge(h3, b, p_bs)
        self.edge(p_bs, 0x5C, p_u)
        self.edge(p_u, ord("u"), p0)
        for b in b"dD":
            self.edge(p0, b, p1)
        for b in b"cdefCDEF":
            self.edge(p1, b, p2)
        for b in self._HEX:
            self.edge(p2, b, p3)
            self.edge(p3, b, dst)
        # DCxx-DFxx first (a lone LOW surrogate): no edge — dead.

    def string(self, src: int) -> int:
        quote = self.new_state()
        self.edge(src, 0x22, quote)
        return self.string_body(quote)

    def char_unit(self, src: int, dst: int) -> None:
        """Wire ``src -> dst`` consuming exactly ONE logical string character:
        a plain ASCII char, a backslash escape (incl. ``\\uXXXX``), or one
        complete well-formed UTF-8 multibyte sequence. This is the unit that
        min/maxLength count (JSON string length is characters, not bytes)."""
        for b in range(0x20, 0x80):
            if b not in (0x22, 0x5C):
                self.edge(src, b, dst)
        esc = self.new_state()
        self.edge(src, 0x5C, esc)
        for b in b'"\\/bfnrt':
            self.edge(esc, b, dst)
        self._u_escape(esc, dst)  # surrogate pair = one character
        # UTF-8 multibyte, same well-formedness windows as string_body.
        c1 = self.new_state()
        c2 = self.new_state()
        c3 = self.new_state()
        e0 = self.new_state()
        ed = self.new_state()
        f0 = self.new_state()
        f4 = self.new_state()
        for b in range(0xC2, 0xE0):
            self.edge(src, b, c1)
        self.edge(src, 0xE0, e0)
        for b in [*range(0xE1, 0xED), 0xEE, 0xEF]:
            self.edge(src, b, c2)
        self.edge(src, 0xED, ed)
        self.edge(src, 0xF0, f0)
        for b in range(0xF1, 0xF4):
            self.edge(src, b, c3)
        self.edge(src, 0xF4, f4)
        for b in range(0x80, 0xC0):
            self.edge(c1, b, dst)
            self.edge(c2, b, c1)
            self.edge(c3, b, c2)
        for b in range(0xA0, 0xC0):
            self.edge(e0, b, c1)
        for b in range(0x80, 0xA0):
            self.edge(ed, b, c1)
        for b in range(0x90, 0xC0):
            self.edge(f0, b, c2)
        for b in range(0x80, 0x90):
            self.edge(f4, b, c2)

    _MAX_COUNTED_LEN = 128

    def string_counted(self, src: int, min_len: int, max_len) -> int:
        """String with character-count bounds, unrolled one char-unit per
        position. ``max_len=None`` means unbounded above ``min_len`` (the tail
        loops); a finite bound is capped so the unroll can't explode."""
        if max_len is not None and max_len > self._MAX_COUNTED_LEN:
            raise SchemaUnsupported(
                f"maxLength {max_len} > {self._MAX_COUNTED_LEN} (unroll cap)"
            )
        if max_len is not None and min_len > max_len:
            raise SchemaUnsupported("minLength exceeds maxLength")
        quote = self.new_state()
        self.edge(src, 0x22, quote)
        end = self.new_state()
        cur = quote
        if max_len is None:
            for _ in range(min_len):
                nxt = self.new_state()
                self.char_unit(cur, nxt)
                cur = nxt
            self.edge(cur, 0x22, end)
            if min_len:
                # Past the minimum the tail is a free loop (like string_body).
                loop = self.new_state()
                self.char_unit(cur, loop)
                self.char_unit(loop, loop)
                self.edge(loop, 0x22, end)
            else:
                self.char_unit(cur, cur)
            return end
        for i in range(max_len):
            if i >= min_len:
                self.edge(cur, 0x22, end)
            nxt = self.new_state()
            self.char_unit(cur, nxt)
            cur = nxt
        self.edge(cur, 0x22, end)
        return end

    def _digit_range(self, src: int, dst: int, lo: int, hi: int) -> None:
        for d in range(lo, hi + 1):
            self.edge(src, ord("0") + d, dst)

    def formatted_string(self, src: int, fmt: str) -> int:
        """Lexical shapes for the common pydantic string formats. The mask
        guarantees the SHAPE (digit ranges included); full calendar validity
        (leap years, 30-day months) stays with post-hoc model validation."""
        quote = self.new_state()
        self.edge(src, 0x22, quote)
        if fmt == "date":  # YYYY-MM-DD, month 01-12, day 01-31
            cur = quote
            for _ in range(4):
                nxt = self.new_state()
                self._digit_range(cur, nxt, 0, 9)
                cur = nxt
            cur = self.literal(cur, b"-")
            m0, m1, m_end = self.new_state(), self.new_state(), self.new_state()
            self.edge(cur, ord("0"), m0)
            self.edge(cur, ord("1"), m1)
            self._digit_range(m0, m_end, 1, 9)
            self._digit_range(m1, m_end, 0, 2)
            cur = self.literal(m_end, b"-")
            d0, d12, d3, d_end = (self.new_state() for _ in range(4))
            self.edge(cur, ord("0"), d0)
            for b in b"12":
                self.edge(cur, b, d12)
            self.edge(cur, ord("3"), d3)
            self._digit_range(d0, d_end, 1, 9)
            self._digit_range(d12, d_end, 0, 9)
            self._digit_range(d3, d_end, 0, 1)
            return self.close(d_end, b'"')
        if fmt == "time":  # HH:MM:SS, hour 00-23, min/sec 00-59
            h01, h2, h_end = self.new_state(), self.new_state(), self.new_state()
            for b in b"01":
                self.edge(quote, b, h01)
            self.edge(quote, ord("2"), h2)
            self._digit_range(h01, h_end, 0, 9)
            self._digit_range(h2, h_end, 0, 3)
            cur = h_end
            for _ in range(2):
                cur = self.literal(cur, b":")
                hi, lo_end = self.new_state(), self.new_state()
                self._digit_range(cur, hi, 0, 5)
                self._digit_range(hi, lo_end, 0, 9)
                cur = lo_end
            return self.close(cur, b'"')
        if fmt == "uuid":  # 8-4-4-4-12 hex, either case
            cur = quote
            for i, run in enumerate((8, 4, 4, 4, 12)):
                if i:
                    cur = self.literal(cur, b"-")
                for _ in range(run):
                    nxt = self.new_state()
                    for b in b"0123456789abcdefABCDEF":
                        self.edge(cur, b, nxt)
                    cur = nxt
            return self.close(cur, b'"')
        raise SchemaUnsupported(f"unsupported string format {fmt!r}")

    def number(self, src: int, integer_only: bool = False) -> int:
        """JSON number; the end state is the ACCEPTING state reached only once
        at least one digit exists. Digits self-loop on the end state."""
        end = self.new_state()       # >=1 int digit seen (accepting)
        zero = self.new_state()      # leading 0: no more int digits
        minus = self.new_state()
        self.edge(src, ord("-"), minus)
        for s in (src, minus):
            self.edge(s, ord("0"), zero)
            for d in _DIGITS[1:]:
                self.edge(s, d, end)
        for d in _DIGITS:
            self.edge(end, d, end)
        terminals = [end, zero]
        if not integer_only:
            dot = self.new_state()
            frac = self.new_state()
            e = self.new_state()
            esign = self.new_state()
            exp = self.new_state()
            for s in (end, zero):
                self.edge(s, ord("."), dot)
                for eb in b"eE":
                    self.edge(s, eb, e)
            for d in _DIGITS:
                self.edge(dot, d, frac)
                self.edge(frac, d, frac)
                self.edge(e, d, exp)
                self.edge(esign, d, exp)
                self.edge(exp, d, exp)
            for eb in b"eE":
                self.edge(frac, eb, e)
            for sgn in b"+-":
                self.edge(e, sgn, esign)
            terminals += [frac, exp]
        # Merge the number's accepting states into ONE end by epsilon-free
        # convention: callers continue from a fresh state reachable from every
        # terminal on the FOLLOW byte — instead we return a list; see follow().
        self._num_terminals = terminals
        return terminals  # type: ignore[return-value]

    def value(self, src: int, schema: dict, defs: dict) -> List[int]:
        """Wire a schema value from ``src``; returns accepting state(s)."""
        schema = self.resolve(schema, defs)
        if "const" in schema:
            return [self.literal(src, json.dumps(schema["const"]).encode())]
        if "enum" in schema:
            return self.trie(src, [json.dumps(v).encode() for v in schema["enum"]])
        if "anyOf" in schema or "oneOf" in schema:
            arms = schema.get("anyOf") or schema.get("oneOf")
            ends: List[int] = []
            for arm in arms:
                ends.extend(self.value(src, arm, defs))
            return ends
        t = schema.get("type")
        if isinstance(t, list):
            ends = []
            for tt in t:
                ends.extend(self.value(src, {**schema, "type": tt}, defs))
            return ends
        if t == "string":
            fmt = schema.get("format")
            if fmt is not None:
                return [self.formatted_string(src, fmt)]
            min_len = schema.get("minLength")
            max_len = schema.get("maxLength")
            if min_len is not None or max_len is not None:
                return [self.string_counted(src, int(min_len or 0), max_len)]
            return [self.string(src)]
        if t == "integer":
            return self.number(src, integer_only=True)  # type: ignore[return-value]
        if t == "number":
            return self.number(src)  # type: ignore[return-value]
        if t == "boolean":
            return [self.literal(src, b"true"), self.literal(src, b"false")]
        if t == "null":
            return [self.literal(src, b"null")]
        if t == "object":
            return [self.object(src, schema, defs)]
        if t == "array":
            return [self.array(src, schema, defs)]
        raise SchemaUnsupported(f"unsupported schema node: {schema!r}")

    def object(self, src: int, schema: dict, defs: dict) -> int:
        props = schema.get("properties")
        if not props:
            raise SchemaUnsupported("object without properties (free-form)")
        if schema.get("additionalProperties") not in (False, None):
            raise SchemaUnsupported("additionalProperties")
        cur = self.literal(src, b"{")
        for i, (name, sub) in enumerate(props.items()):
            prefix = (b"," if i else b"") + json.dumps(name).encode() + b":"
            cur = self.literal(cur, prefix)
            ends = self.value(cur, sub, defs)
            cur = self.follow(ends)
        return self.close(cur, b"}")

    def array(self, src: int, schema: dict, defs: dict) -> int:
        items = schema.get("items")
        if not items:
            raise SchemaUnsupported("array without items schema")
        open_ = self.literal(src, b"[")
        end = self.new_state()
        self.edge(open_, ord("]"), end)  # empty array
        elem_ends = self.value(open_, items, defs)
        again = self.new_state()
        for e in elem_ends:
            self.edge(e, ord(","), again)
            self.edge(e, ord("]"), end)
        more_ends = self.value(again, items, defs)
        for e in more_ends:
            self.edge(e, ord(","), again)
            self.edge(e, ord("]"), end)
        return end

    def trie(self, src: int, literals: List[bytes]) -> List[int]:
        """Shared-prefix trie over literal alternatives (string enums)."""
        ends: List[int] = []
        by_state: Dict[Tuple[int, int], int] = {}
        for lit in literals:
            cur = src
            for i, b in enumerate(lit):
                nxt = self.trans[cur].get(b)
                if nxt is None:
                    nxt = self.new_state()
                    self.edge(cur, b, nxt)
                cur = nxt
            ends.append(cur)
        return ends

    def follow(self, ends: List[int]) -> int:
        """Merge multiple accepting states: later edges added to the merged
        state are mirrored onto every end (numbers terminate lazily, so the
        next literal byte decides where the value stopped)."""
        if len(ends) == 1:
            return ends[0]
        merged = self.new_state()
        self._merges.setdefault(merged, []).extend(ends)
        return merged

    def close(self, cur: int, lit: bytes) -> int:
        return self.literal(cur, lit)

    def resolve(self, schema: dict, defs: dict) -> dict:
        seen = 0
        while "$ref" in schema:
            ref = schema["$ref"]
            if not ref.startswith("#/$defs/"):
                raise SchemaUnsupported(f"unsupported $ref {ref!r}")
            schema = defs[ref.split("/")[-1]]
            seen += 1
            if seen > 16:
                raise SchemaUnsupported("recursive $ref")
        return schema

    _merges: Dict[int, List[int]] = {}


def compile_schema(schema: dict) -> SchemaDFA:
    """Compile a JSON Schema dict (pydantic ``model_json_schema()``) to a DFA.
    Raises :class:`SchemaUnsupported` for constructs outside the subset."""
    b = _Builder()
    b._merges = {}
    defs = schema.get("$defs", {})
    start = b.new_state()
    ends = b.value(start, schema, defs)

    # Propagate merged-state edges back onto their sources (see follow()).
    # Iterate to a fixed point: merged states may chain.
    changed = True
    while changed:
        changed = False
        for merged, sources in b._merges.items():
            for byte, dst in list(b.trans[merged].items()):
                for s in sources:
                    if b.trans[s].get(byte) is None:
                        b.trans[s][byte] = dst
                        changed = True

    n = len(b.trans)
    trans = np.full((n, 256), -1, np.int32)
    for s, edges in enumerate(b.trans):
        for byte, dst in edges.items():
            trans[s, byte] = dst
    terminal = np.zeros(n, bool)
    for e in ends:
        terminal[e] = True
        for src_list in ([b._merges[e]] if e in b._merges else []):
            for s in src_list:
                terminal[s] = True

    digest = hashlib.sha256(
        json.dumps(schema, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]
    return SchemaDFA(trans=trans, terminal=terminal, start=start, digest=digest)


def validate_bytes(dfa: SchemaDFA, data: bytes) -> Tuple[bool, bool]:
    """(valid_prefix, complete) — host-side oracle mirroring the device mask."""
    state = dfa.start
    for byte in data:
        nxt = int(dfa.trans[state, byte])
        if nxt < 0:
            return False, False
        state = nxt
    return True, bool(dfa.terminal[state])


# --- device side (torch, no host sync) -----------------------------------

class DeviceDFA(NamedTuple):
    trans: "object"     # [S, 256] int64 (device)
    allowed: "object"   # [S, 256] bool
    terminal: "object"  # [S] bool
    start: int
    digest: str


def device_dfa(dfa: SchemaDFA, device="cpu") -> DeviceDFA:
    import torch

    return DeviceDFA(
        trans=torch.as_tensor(dfa.trans, dtype=torch.int64, device=device),
        allowed=torch.as_tensor(dfa.trans >= 0, device=device),
        terminal=torch.as_tensor(dfa.terminal, device=device),
        start=dfa.start,
        digest=dfa.digest,
    )


def dfa_initial_state(d: DeviceDFA, n: int):
    import torch

    return torch.full((n,), d.start, dtype=torch.int64, device=d.trans.device)


def dfa_mask_logits(d: DeviceDFA, logits, state, eos_arr):
    import torch

    from ._indexing import jax_rows, open_eos

    n, V = logits.shape
    st = jax_rows(state, d.allowed.shape[0])
    mask = torch.zeros((n, V), dtype=torch.bool, device=logits.device)
    mask[:, :256] = d.allowed[st][:, : min(256, V)]
    open_eos(mask, eos_arr, d.terminal[st])
    return torch.where(mask, logits, torch.finfo(logits.dtype).min)


def dfa_advance(d: DeviceDFA, token, state):
    import torch

    from ._indexing import jax_rows

    is_byte = token < 256
    nxt = d.trans[jax_rows(state, d.trans.shape[0]), token.clamp(0, 255)]
    return torch.where(is_byte, nxt, state)
