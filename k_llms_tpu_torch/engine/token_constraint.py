"""Token-level grammar constraints for BPE vocabularies.

The byte-level automata (``json_constraint``, ``schema_constraint``) guarantee
grammatical output only when token id == byte. Real checkpoints (Llama-3,
Qwen, Gemma) use BPE merges, so the guarantee must be lifted to the token
level — the server-side enforcement the reference delegates to OpenAI
(`k_llms/resources/completions/completions.py:134`) becomes a
vocabulary-compiled mask here, à la Outlines:

- HOST, once per (grammar, vocabulary): every vocab token's byte string is
  walked through the byte automaton from every state simultaneously (a
  level-synchronous numpy walk, chunked over states), producing a packed
  per-state token bitmask ``[S, ceil(V/8)]``. For the generic JSON grammar the
  pushdown stack is first product-expanded over a bounded nesting depth, so
  the result is a true DFA; schemas compile to stackless DFAs already.
- DEVICE, per decode step: the mask is a row gather + 8-way bit unpack; the
  state advance re-walks just the sampled token's bytes with a short
  loop over byte columns (so the huge [S, V] next-state table never exists on
  device).

Depth bound: generic-JSON token masks enforce nesting <= ``max_depth``
(default 4) — bounded-depth JSON is still valid JSON, and schema-derived DFAs
(the primary ``parse()`` path) carry no such bound since their nesting is
static in the schema.
"""

from __future__ import annotations

import hashlib
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .json_constraint import (
    CTX_ARR,
    CTX_OBJ,
    OP_POP,
    OP_PUSH_ARR,
    OP_PUSH_OBJ,
    S as JSTATE,
    SENT_CLOSE,
    SENT_COMMA,
    build_tables,
)
from .schema_constraint import SchemaDFA

MAX_TOKEN_BYTES = 32  # longer tokens are banned (the model just picks smaller ones)


class TokenConstraint(NamedTuple):
    """Host-side compiled artifact: a resolved byte DFA + per-state token masks."""

    packed: np.ndarray  # [S, ceil(V/8)] uint8 allowed-token bits (bitorder big)
    trans: np.ndarray  # [S, 256] int32 fully-resolved byte automaton (-1 invalid)
    terminal: np.ndarray  # [S] bool: EOS legal here
    token_bytes: np.ndarray  # [V, L] uint8
    token_len: np.ndarray  # [V] int32 (0 = special/unmapped/overlong: never masked in)
    start: int
    digest: str
    vocab_size: int


# --------------------------------------------------------------------------
# Vocabulary -> byte strings
# --------------------------------------------------------------------------

def _gpt2_byte_decoder() -> dict:
    """Invert the GPT-2 bytes<->unicode bijection used by byte-level BPE."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    mapped = keep[:]
    shift = 0
    for b in range(256):
        if b not in keep:
            mapped.append(0x100 + shift)
            shift += 1
    all_bytes = keep + [b for b in range(256) if b not in keep]
    return {chr(u): b for b, u in zip(all_bytes, mapped)}


def vocab_byte_strings(tokenizer: Any) -> List[Optional[bytes]]:
    """Byte string of every token id, or None for specials/unmappable tokens.

    Handles byte-level BPE (GPT-2/Llama-3 'Ġ' convention) and SentencePiece
    ('▁' word boundary + '<0xNN>' byte tokens). Accepts an ``HFTokenizer``
    wrapper or a raw transformers tokenizer.
    """
    hf = getattr(tokenizer, "_tok", tokenizer)
    n = len(hf)
    specials = set(getattr(hf, "all_special_ids", []) or [])
    pieces = hf.convert_ids_to_tokens(list(range(n)))

    byte_level = any("Ġ" in (p or "") for p in pieces)  # 'Ġ' = encoded space
    decoder = _gpt2_byte_decoder() if byte_level else None

    out: List[Optional[bytes]] = []
    for i, piece in enumerate(pieces):
        if i in specials or piece is None:
            out.append(None)
            continue
        if byte_level:
            try:
                out.append(bytes(decoder[ch] for ch in piece))
            except KeyError:  # added token outside the byte alphabet
                out.append(None)
        elif len(piece) == 6 and piece.startswith("<0x") and piece.endswith(">"):
            out.append(bytes([int(piece[3:5], 16)]))
        else:
            out.append(piece.replace("▁", " ").encode("utf-8"))
    return out


def _byte_table(vocab: Sequence[Optional[bytes]]) -> Tuple[np.ndarray, np.ndarray]:
    width = max(
        (len(b) for b in vocab if b is not None and 0 < len(b) <= MAX_TOKEN_BYTES),
        default=1,
    )
    table = np.zeros((len(vocab), width), np.uint8)
    lengths = np.zeros(len(vocab), np.int32)
    for i, b in enumerate(vocab):
        if b is None or not (0 < len(b) <= MAX_TOKEN_BYTES):
            continue
        table[i, : len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return table, lengths


# --------------------------------------------------------------------------
# Generic JSON: pushdown -> bounded-depth product DFA
# --------------------------------------------------------------------------

def json_product_automaton(max_depth: int = 4) -> Tuple[np.ndarray, np.ndarray, int]:
    """Expand the JSON PDA over all stack configurations of depth <= max_depth.
    Returns (trans [S', 256] int32, terminal [S'] bool, start)."""
    t = build_tables()
    # Enumerate stack configurations breadth-first by depth: {OBJ, ARR}^d, d <= D.
    configs: List[Tuple[int, ...]] = [()]
    frontier: List[Tuple[int, ...]] = [()]
    for _ in range(max_depth):
        frontier = [c + (ctx,) for c in frontier for ctx in (CTX_OBJ, CTX_ARR)]
        configs += frontier
    cfg_id = {c: i for i, c in enumerate(configs)}

    n_json = t.trans.shape[0]
    n_prod = n_json * len(configs)

    def pid(state: int, cfg: Tuple[int, ...]) -> int:
        return state * len(configs) + cfg_id[cfg]

    trans = np.full((n_prod, 256), -1, np.int32)
    terminal = np.zeros(n_prod, bool)

    for s in range(n_json):
        for cfg in configs:
            row = pid(s, cfg)
            terminal[row] = bool(t.terminal[s]) and not cfg
            for b in range(256):
                nxt = int(t.trans[s, b])
                if nxt < 0:
                    continue
                op = int(t.stackop[s, b])
                if op in (OP_PUSH_OBJ, OP_PUSH_ARR):
                    if len(cfg) == max_depth:
                        continue  # depth guard: the push is simply not offered
                    cfg2 = cfg + (CTX_OBJ if op == OP_PUSH_OBJ else CTX_ARR,)
                elif op == OP_POP:
                    want = CTX_OBJ if b == ord("}") else CTX_ARR
                    if not cfg or cfg[-1] != want:
                        continue
                    cfg2 = cfg[:-1]
                else:
                    cfg2 = cfg
                if nxt == SENT_COMMA:
                    if not cfg2:
                        continue  # ',' outside any container
                    s2 = JSTATE["KEY_START"] if cfg2[-1] == CTX_OBJ else JSTATE["VALUE"]
                elif nxt == SENT_CLOSE:
                    s2 = JSTATE["DONE"] if not cfg2 else JSTATE["AFTER_VALUE"]
                else:
                    s2 = nxt
                trans[row, b] = pid(s2, cfg2)

    return trans, terminal, pid(JSTATE["VALUE"], ())


# --------------------------------------------------------------------------
# The vocabulary walk (host, vectorized)
# --------------------------------------------------------------------------

def _walk_vocab(
    trans: np.ndarray, token_bytes: np.ndarray, token_len: np.ndarray, chunk: int = 256
) -> np.ndarray:
    """allowed[s, v] = the whole byte string of token v is walkable from s."""
    n_states = trans.shape[0]
    n_vocab, width = token_bytes.shape
    allowed = np.zeros((n_states, n_vocab), bool)
    cols = token_bytes.astype(np.int64)
    for lo in range(0, n_states, chunk):
        hi = min(n_states, lo + chunk)
        state = np.repeat(np.arange(lo, hi, dtype=np.int32)[:, None], n_vocab, axis=1)
        for step in range(width):
            live = (token_len > step)[None, :] & (state >= 0)
            nxt = trans[np.maximum(state, 0), cols[None, :, step]]
            state = np.where(live, nxt, state)
        allowed[lo:hi] = (state >= 0) & (token_len > 0)[None, :]
    return allowed


def _prune_unreachable(
    trans: np.ndarray, terminal: np.ndarray, start: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Drop states unreachable from ``start`` (product expansion leaves many)."""
    reachable = np.zeros(trans.shape[0], bool)
    reachable[start] = True
    frontier = np.array([start])
    while frontier.size:
        nxt = trans[frontier]
        nxt = np.unique(nxt[nxt >= 0])
        frontier = nxt[~reachable[nxt]]
        reachable[frontier] = True
    remap = np.full(trans.shape[0], -1, np.int32)
    remap[reachable] = np.arange(int(reachable.sum()), dtype=np.int32)
    new_trans = trans[reachable]
    new_trans = np.where(new_trans >= 0, remap[np.maximum(new_trans, 0)], -1)
    return new_trans, terminal[reachable], int(remap[start])


def compile_token_constraint(
    trans: np.ndarray,
    terminal: np.ndarray,
    start: int,
    vocab: Sequence[Optional[bytes]],
    digest: str,
) -> TokenConstraint:
    trans, terminal, start = _prune_unreachable(trans.astype(np.int32), terminal, start)
    token_bytes, token_len = _byte_table(vocab)
    allowed = _walk_vocab(trans.astype(np.int32), token_bytes, token_len)
    return TokenConstraint(
        packed=np.packbits(allowed, axis=1),
        trans=trans.astype(np.int32),
        terminal=terminal.astype(bool),
        token_bytes=token_bytes,
        token_len=token_len,
        start=int(start),
        digest=digest,
        vocab_size=len(vocab),
    )


def _vocab_digest(vocab: Sequence[Optional[bytes]]) -> str:
    h = hashlib.sha256()
    for b in vocab:
        h.update(b"\x00" if b is None else b + b"\x01")
    return h.hexdigest()[:16]


def json_token_constraint(
    vocab: Sequence[Optional[bytes]], max_depth: int = 4
) -> TokenConstraint:
    trans, terminal, start = json_product_automaton(max_depth)
    digest = f"json-d{max_depth}-{_vocab_digest(vocab)}"
    return compile_token_constraint(trans, terminal, start, vocab, digest)


def schema_token_constraint(
    dfa: SchemaDFA, vocab: Sequence[Optional[bytes]]
) -> TokenConstraint:
    digest = f"schema-{dfa.digest}-{_vocab_digest(vocab)}"
    return compile_token_constraint(dfa.trans, dfa.terminal, dfa.start, vocab, digest)


# --------------------------------------------------------------------------
# Host-side oracle (tests)
# --------------------------------------------------------------------------

def validate_tokens(tc: TokenConstraint, ids: Sequence[int]) -> Tuple[bool, bool]:
    """(every step was mask-allowed, final state is terminal)."""
    state = tc.start
    for i in ids:
        if not (0 <= i < tc.vocab_size) or tc.token_len[i] == 0:
            return False, False
        if not (tc.packed[state, i // 8] >> (7 - i % 8)) & 1:
            return False, False
        for b in tc.token_bytes[i, : tc.token_len[i]]:
            state = int(tc.trans[state, b])
    return True, bool(tc.terminal[state])


# --------------------------------------------------------------------------
# Device side (torch, no host sync)
# --------------------------------------------------------------------------

class DeviceTokenTable(NamedTuple):
    packed: "object"  # [S, P] uint8
    trans: "object"  # [S, 256] int64
    terminal: "object"  # [S] bool
    token_bytes: "object"  # [V, L] uint8
    token_len: "object"  # [V] int64
    start: int
    vocab_size: int


def device_token_table(tc: TokenConstraint, device="cpu") -> DeviceTokenTable:
    import torch

    return DeviceTokenTable(
        packed=torch.as_tensor(tc.packed, device=device),
        trans=torch.as_tensor(tc.trans, dtype=torch.int64, device=device),
        terminal=torch.as_tensor(tc.terminal, device=device),
        token_bytes=torch.as_tensor(tc.token_bytes, dtype=torch.uint8, device=device),
        token_len=torch.as_tensor(tc.token_len, dtype=torch.int64, device=device),
        start=tc.start,
        vocab_size=tc.vocab_size,
    )


def token_initial_state(t: DeviceTokenTable, n: int):
    import torch

    return torch.full((n,), t.start, dtype=torch.int64, device=t.trans.device)


def token_mask_logits(t: DeviceTokenTable, logits, state, eos_arr):
    """[n, V] logits -> masked. Vocab columns follow the packed bitmask; EOS
    columns open on terminal states; columns past the tokenizer vocab stay
    banned."""
    import torch

    from ._indexing import jax_rows, open_eos

    n, v_logits = logits.shape
    st = jax_rows(state, t.packed.shape[0])
    rows = t.packed[st]  # [n, P]
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=rows.device)
    bits = (rows[:, :, None] >> shifts[None, None, :]) & 1
    bits = bits.reshape(n, -1)[:, : t.vocab_size].bool()

    mask = torch.zeros((n, v_logits), dtype=torch.bool, device=logits.device)
    k = min(t.vocab_size, v_logits)
    mask[:, :k] = bits[:, :k]
    open_eos(mask, eos_arr, t.terminal[st])
    return torch.where(mask, logits, torch.finfo(logits.dtype).min)


def token_advance(t: DeviceTokenTable, token, state):
    """Walk the sampled token's bytes through the automaton ([n] ids).
    Specials / pad (token_len == 0) freeze the row."""
    import torch

    tok = token.clamp(0, t.vocab_size - 1)
    ln = torch.where(token < t.vocab_size, t.token_len[tok], 0)
    n_states = t.trans.shape[0]
    st = state
    for i in range(t.token_bytes.shape[1]):
        b = t.token_bytes[tok, i].long()
        live = (i < ln) & (st >= 0)
        st = torch.where(live, t.trans[st.clamp(0, n_states - 1), b], st)
    return torch.where(ln > 0, st, state)
