"""Compiled grammar masks: schema -> token-level mask automaton, cached fleet-wide.

This is the fast path for ``parse()`` workloads: a JSON schema is
compiled once into a :class:`CompiledGrammar` — a dense per-state allowed-token
bitmask packed as a ``[states, ceil(vocab/32)] uint32`` array plus a byte-walk
``advance(state, token) -> state`` transition — and applied in-decode as a fused
on-device logits mask, so all n consensus samples are valid by construction and
parse-failure retries disappear.

Layering relative to the older constraint surface:

- ``schema_constraint.compile_schema`` still builds the byte-level DFA and
  ``token_constraint`` still owns the vocabulary walk; this module lifts their
  output into the uint32-packed device layout and owns *caching* and *fallback*.
- Compilation is memoized in a process-wide TTL cache keyed by
  ``(schema digest, vocab digest)``.  ReplicaSet members share one process, and
  members of a fleet share vocabularies (identical tokenizer => identical vocab
  digest), so each schema compiles once per fleet, not once per request.
  Cache stats surface through :func:`grammar_cache_stats`.
- :func:`grammar_for_schema` never raises.  Unsupported schema features degrade
  to the generic JSON grammar (post-hoc schema validation stays authoritative);
  compile errors and the ``engine.grammar`` failpoint degrade to ``None``
  (unconstrained decode + post-hoc validation).  Every degradation increments a
  ``GRAMMAR_EVENTS`` counter so the fallback is observable, never silent.

Device-side ops mirror ``token_constraint``'s but unpack 32-bit words:
bit ``j`` of word ``w`` covers token ``w*32 + j`` (little-bit order), so the
mask gather is a single row gather + shift — no host work per step.  They are
torch ops on the tables' device that never read a value back to the host, so
the engine's decode loop (``engine._decode``) masks and advances every step
without a sync.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..consensus.cache import TTLCache
from ..reliability import failpoints as _failpoints
from ..utils.observability import GRAMMAR_EVENTS
from .schema_constraint import SchemaUnsupported, compile_schema
from .token_constraint import (
    _byte_table,
    _prune_unreachable,
    _vocab_digest,
    _walk_vocab,
    json_product_automaton,
    vocab_byte_strings,
)


class CompiledGrammar(NamedTuple):
    """Token-level mask automaton for one (schema, vocabulary) pair."""

    masks: np.ndarray  # [S, ceil(V/32)] uint32, bit j of word w = token w*32+j
    trans: np.ndarray  # [S, 256] int32 byte transitions, -1 = dead
    terminal: np.ndarray  # [S] bool — EOS may open here
    token_bytes: np.ndarray  # [V, L] uint8
    token_len: np.ndarray  # [V] int32, 0 = special/unreachable token
    start: int
    digest: str
    vocab_size: int


# --------------------------------------------------------------------------
# Compilation (host, once per (schema, vocab))
# --------------------------------------------------------------------------

def _pack_u32(allowed: np.ndarray) -> np.ndarray:
    """[S, V] bool -> [S, ceil(V/32)] uint32 in little-bit order."""
    n_states, n_vocab = allowed.shape
    words = (n_vocab + 31) // 32
    padded = np.zeros((n_states, words * 32), bool)
    padded[:, :n_vocab] = allowed
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (padded.reshape(n_states, words, 32).astype(np.uint32) * weights).sum(
        axis=2, dtype=np.uint32
    )


def compile_grammar(
    trans: np.ndarray,
    terminal: np.ndarray,
    start: int,
    vocab: Sequence[Optional[bytes]],
    digest: str,
) -> CompiledGrammar:
    """Lift a byte automaton into the packed token-mask layout."""
    trans, terminal, start = _prune_unreachable(trans.astype(np.int32), terminal, start)
    token_bytes, token_len = _byte_table(vocab)
    allowed = _walk_vocab(trans.astype(np.int32), token_bytes, token_len)
    GRAMMAR_EVENTS.record("grammar.compile")
    return CompiledGrammar(
        masks=_pack_u32(allowed),
        trans=trans.astype(np.int32),
        terminal=terminal.astype(bool),
        token_bytes=token_bytes,
        token_len=token_len,
        start=int(start),
        digest=digest,
        vocab_size=len(vocab),
    )


def grammar_vocab(tokenizer: Any) -> List[Optional[bytes]]:
    """Per-token byte strings for any tokenizer family.

    Byte-level vocabs map ids 0..255 to single bytes (specials above stay
    ``None`` so the walk bans them and EOS opens only via the terminal check);
    BPE vocabs go through ``vocab_byte_strings``'s byte-decoder path.
    """
    if getattr(tokenizer, "is_byte_level", False):
        vocab: List[Optional[bytes]] = [bytes([i]) for i in range(256)]
        vocab.extend([None] * (tokenizer.vocab_size - 256))
        return vocab
    return vocab_byte_strings(tokenizer)


# --------------------------------------------------------------------------
# Process-wide cache: one compile per (schema digest, vocab digest) per fleet
# --------------------------------------------------------------------------

_CACHE = TTLCache(maxsize=64, ttl=3600.0, name="grammar")


def grammar_cache_stats() -> dict:
    """Hit/miss/entry counters for ``health()`` and ``/metrics``."""
    return _CACHE.stats()


def clear_grammar_cache() -> None:
    """Test hook: drop all compiled grammars."""
    _CACHE.clear()


def _compile_for_schema(
    schema: Optional[dict], vocab: Sequence[Optional[bytes]], vocab_digest: str
) -> CompiledGrammar:
    """Schema automaton when supported, generic-JSON product otherwise."""
    if schema is not None:
        try:
            dfa = compile_schema(schema)
            digest = f"grammar-{dfa.digest}-{vocab_digest}"
            return compile_grammar(dfa.trans, dfa.terminal, dfa.start, vocab, digest)
        except SchemaUnsupported:
            GRAMMAR_EVENTS.record("grammar.fallback_unsupported")
    trans, terminal, start = json_product_automaton()
    return compile_grammar(trans, terminal, start, vocab, f"grammar-json-{vocab_digest}")


def grammar_for_schema(
    schema: Optional[dict],
    vocab: Sequence[Optional[bytes]],
    vocab_digest: Optional[str] = None,
) -> Optional[CompiledGrammar]:
    """Compile-or-fetch the grammar for ``schema`` over ``vocab``.

    Never raises: unsupported schema features degrade to the generic JSON
    grammar (cached under the schema's key so the miss is paid once), and any
    compile error — or the ``engine.grammar`` failpoint — degrades to ``None``
    (unconstrained decode, post-hoc validation).  All degradations are counted.
    """
    try:
        spec = _failpoints.fire("engine.grammar")
        if spec is not None and spec.action == "fallback":
            GRAMMAR_EVENTS.record("grammar.fallback_failpoint")
            return None
        if vocab_digest is None:
            vocab_digest = _vocab_digest(vocab)
        import hashlib
        import json

        schema_digest = (
            "json"
            if schema is None
            else hashlib.sha256(
                json.dumps(schema, sort_keys=True, default=str).encode()
            ).hexdigest()[:16]
        )
        key = (schema_digest, vocab_digest)
        cached = _CACHE.get(key)
        if cached is not None:
            GRAMMAR_EVENTS.record("grammar.hit")
            return cached
        GRAMMAR_EVENTS.record("grammar.miss")
        compiled = _compile_for_schema(schema, vocab, vocab_digest)
        _CACHE.set(key, compiled)
        return compiled
    except Exception:
        GRAMMAR_EVENTS.record("grammar.fallback_error")
        return None


# --------------------------------------------------------------------------
# Host-side oracle (tests)
# --------------------------------------------------------------------------

def validate_grammar_tokens(g: CompiledGrammar, ids: Sequence[int]) -> Tuple[bool, bool]:
    """(every step was mask-allowed, final state is terminal)."""
    state = g.start
    for i in ids:
        if not (0 <= i < g.vocab_size) or g.token_len[i] == 0:
            return False, False
        if not (g.masks[state, i // 32] >> (i % 32)) & 1:
            return False, False
        for b in g.token_bytes[i, : g.token_len[i]]:
            state = int(g.trans[state, b])
    return True, bool(g.terminal[state])


# --------------------------------------------------------------------------
# Device side (torch, no host sync; the fused per-step ops)
# --------------------------------------------------------------------------

class DeviceGrammar(NamedTuple):
    masks: "object"  # [S, W] int32, the uint32 words' bits
    trans: "object"  # [S, 256] int64
    terminal: "object"  # [S] bool
    token_bytes: "object"  # [V, L] uint8
    token_len: "object"  # [V] int64
    start: int
    vocab_size: int


def device_grammar(g: CompiledGrammar, pad_states: int = 0, device="cpu") -> DeviceGrammar:
    """Upload the tables.  ``pad_states`` rounds the state axis up (next power
    of two at or above it) so differently-sized schemas share one table
    shape; padded rows are dead (trans -1, mask 0)."""
    import torch

    masks, trans, terminal = g.masks, g.trans, g.terminal
    if pad_states:
        target = 1
        while target < max(pad_states, trans.shape[0]):
            target *= 2
        extra = target - trans.shape[0]
        if extra:
            masks = np.concatenate(
                [masks, np.zeros((extra, masks.shape[1]), np.uint32)]
            )
            trans = np.concatenate(
                [trans, np.full((extra, 256), -1, np.int32)]
            )
            terminal = np.concatenate([terminal, np.zeros(extra, bool)])
    return DeviceGrammar(
        # The words' bits as int32: an arithmetic shift of a negative word
        # still leaves bit j in place for ``(word >> j) & 1``.
        masks=torch.as_tensor(np.ascontiguousarray(masks, np.uint32).view(np.int32),
                              device=device),
        trans=torch.as_tensor(trans, dtype=torch.int64, device=device),
        terminal=torch.as_tensor(terminal, device=device),
        token_bytes=torch.as_tensor(g.token_bytes, dtype=torch.uint8, device=device),
        token_len=torch.as_tensor(g.token_len, dtype=torch.int64, device=device),
        start=g.start,
        vocab_size=g.vocab_size,
    )


def grammar_initial_state(d: DeviceGrammar, n: int):
    import torch

    return torch.full((n,), d.start, dtype=torch.int64, device=d.trans.device)


def grammar_mask_logits(d: DeviceGrammar, logits, state, eos_arr):
    """[n, V] logits -> masked: one row gather + 32-bit unpack, terminal
    states open the EOS columns, columns past the tokenizer vocab stay
    banned, banned columns take ``finfo(dtype).min``.  Pure device math."""
    import torch

    from ._indexing import jax_rows, open_eos

    n, v_logits = logits.shape
    st = jax_rows(state, d.masks.shape[0])
    rows = d.masks[st]  # [n, W]
    shifts = torch.arange(32, dtype=torch.int32, device=rows.device)
    bits = (rows[:, :, None] >> shifts[None, None, :]) & 1
    bits = bits.reshape(n, -1)[:, : d.vocab_size].bool()

    mask = torch.zeros((n, v_logits), dtype=torch.bool, device=logits.device)
    k = min(d.vocab_size, v_logits)
    mask[:, :k] = bits[:, :k]
    open_eos(mask, eos_arr, d.terminal[st])
    return torch.where(mask, logits, torch.finfo(logits.dtype).min)


def grammar_advance(d: DeviceGrammar, token, state):
    """Walk the sampled token's bytes through the automaton ([n] ids), one
    byte column at a time over ``token_bytes.shape[1]`` columns.  Specials /
    pad (token_len == 0) and ids past the vocabulary freeze the row, so
    finished rows idle."""
    import torch

    tok = token.clamp(0, d.vocab_size - 1)
    ln = torch.where(token < d.vocab_size, d.token_len[tok], 0)
    n_states = d.trans.shape[0]
    st = state
    for i in range(d.token_bytes.shape[1]):
        b = d.token_bytes[tok, i].long()
        live = (i < ln) & (st >= 0)
        st = torch.where(live, d.trans[st.clamp(0, n_states - 1), b], st)
    return torch.where(ln > 0, st, state)
