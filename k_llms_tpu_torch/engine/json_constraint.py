"""Constrained JSON decoding: a byte-level JSON pushdown automaton compiled to
dense transition tables that run inside the decode loop as a logit mask.

The reference delegates structured output to the OpenAI API, which enforces
JSON server-side (`k_llms/resources/completions/completions.py:134`);
a local engine must enforce it during sampling or `parse()` degrades to
best-effort text. With the byte tokenizer (token == byte) the JSON grammar is a
character-level automaton: finite states for the scalar/string/number lexing,
plus a bounded stack for object/array nesting carried through the
decode loop. Per step:

  mask  = ALLOWED[state] (+ stack-dependent closers + depth guard)  -> logits
  state = TRANS[state, emitted_byte] (sentinels resolve via the stack)

Everything data-dependent is a table lookup — no Python control flow and no
host sync in the per-step ops.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np

# --- states ---------------------------------------------------------------
_NAMES = [
    "VALUE",       # expect the start of a value
    "OBJ_OPEN",    # just after '{': key string or '}'
    "ARR_OPEN",    # just after '[': value or ']'
    "KEY",         # inside a key string
    "KEY_ESC",
    "KEY_U1", "KEY_U2", "KEY_U3", "KEY_U4",
    "KEY_C1", "KEY_C2", "KEY_C3",          # UTF-8: pending continuation bytes
    "KEY_E0", "KEY_ED", "KEY_F0", "KEY_F4",  # UTF-8: restricted second byte
    "AFTER_KEY",   # expect ':'
    "STR",         # inside a value string
    "STR_ESC",
    "STR_U1", "STR_U2", "STR_U3", "STR_U4",
    "STR_C1", "STR_C2", "STR_C3",
    "STR_E0", "STR_ED", "STR_F0", "STR_F4",
    "NUM_MINUS",
    "NUM_ZERO",    # strict JSON: a leading 0 takes no further digits
    "NUM_INT",
    "NUM_DOT",
    "NUM_FRAC",
    "NUM_E",
    "NUM_ESIGN",
    "NUM_EXP",
    "T1", "T2", "T3",            # 'rue' of true
    "F1", "F2", "F3", "F4",      # 'alse' of false
    "N1", "N2", "N3",            # 'ull' of null
    "AFTER_VALUE",  # a value just completed
    "KEY_START",    # after ',' inside an object: expect '"'
    "DONE",         # top-level value complete: whitespace only
]
S = {name: i for i, name in enumerate(_NAMES)}
NUM_STATES = len(_NAMES)

# Sentinel next-states, resolved against the stack at runtime.
SENT_COMMA = NUM_STATES       # ',' after a value: object -> KEY_START, array -> VALUE
SENT_CLOSE = NUM_STATES + 1   # '}' / ']': pop; empty stack -> DONE else AFTER_VALUE

# Stack ops.
OP_NONE, OP_PUSH_OBJ, OP_PUSH_ARR, OP_POP = 0, 1, 2, 3
CTX_OBJ, CTX_ARR = 1, 2

_WS = [0x20, 0x09, 0x0A, 0x0D]
_DIGITS = list(range(0x30, 0x3A))
# States from which the enclosing container may be closed by '}' / ']'.
_CLOSABLE = ["NUM_ZERO", "NUM_INT", "NUM_FRAC", "NUM_EXP", "AFTER_VALUE"]
# States where a top-level document may legally end (EOS permitted at depth 0).
_TERMINAL = ["NUM_ZERO", "NUM_INT", "NUM_FRAC", "NUM_EXP", "AFTER_VALUE", "DONE"]


class JsonTables(NamedTuple):
    trans: np.ndarray     # [S, 256] int16 next state, sentinel, or -1 (invalid)
    stackop: np.ndarray   # [S, 256] int8 OP_*
    allowed: np.ndarray   # [S, 256] bool (= trans >= 0)
    closable: np.ndarray  # [S] bool: '}'/']' here close the enclosing container
    terminal: np.ndarray  # [S] bool: EOS legal here when depth == 0


def _value_starts(trans, stackop, state: int) -> None:
    """Wire the start-of-value transitions out of ``state``."""
    trans[state, ord("{")] = S["OBJ_OPEN"]
    stackop[state, ord("{")] = OP_PUSH_OBJ
    trans[state, ord("[")] = S["ARR_OPEN"]
    stackop[state, ord("[")] = OP_PUSH_ARR
    trans[state, ord('"')] = S["STR"]
    trans[state, ord("-")] = S["NUM_MINUS"]
    trans[state, ord("0")] = S["NUM_ZERO"]
    for d in _DIGITS[1:]:
        trans[state, d] = S["NUM_INT"]
    trans[state, ord("t")] = S["T1"]
    trans[state, ord("f")] = S["F1"]
    trans[state, ord("n")] = S["N1"]


def _string_body(trans, state: str, esc: str, u1: str) -> None:
    """In-string transitions: ASCII content, escapes, and WELL-FORMED UTF-8
    multibyte sequences (JSON must be valid UTF-8; a stray continuation byte
    would make the emitted document unparseable)."""
    p = state  # "KEY" or "STR": prefixes the UTF-8 helper states
    for b in range(0x20, 0x80):
        trans[S[state], b] = S[state]
    trans[S[state], ord('"')] = -1  # set by caller (key vs value differ)
    trans[S[state], ord("\\")] = S[esc]
    # UTF-8 lead bytes out of the body state.
    for b in range(0xC2, 0xE0):
        trans[S[state], b] = S[f"{p}_C1"]
    trans[S[state], 0xE0] = S[f"{p}_E0"]
    for b in [*range(0xE1, 0xED), 0xEE, 0xEF]:
        trans[S[state], b] = S[f"{p}_C2"]
    trans[S[state], 0xED] = S[f"{p}_ED"]
    trans[S[state], 0xF0] = S[f"{p}_F0"]
    for b in range(0xF1, 0xF4):
        trans[S[state], b] = S[f"{p}_C3"]
    trans[S[state], 0xF4] = S[f"{p}_F4"]
    # Continuation chains.
    for b in range(0x80, 0xC0):
        trans[S[f"{p}_C1"], b] = S[state]
        trans[S[f"{p}_C2"], b] = S[f"{p}_C1"]
        trans[S[f"{p}_C3"], b] = S[f"{p}_C2"]
    for b in range(0xA0, 0xC0):
        trans[S[f"{p}_E0"], b] = S[f"{p}_C1"]
    for b in range(0x80, 0xA0):
        trans[S[f"{p}_ED"], b] = S[f"{p}_C1"]
    for b in range(0x90, 0xC0):
        trans[S[f"{p}_F0"], b] = S[f"{p}_C2"]
    for b in range(0x80, 0x90):
        trans[S[f"{p}_F4"], b] = S[f"{p}_C2"]
    for b in b'"\\/bfnrt':
        trans[S[esc], b] = S[state]
    trans[S[esc], ord("u")] = S[u1]
    hex_bytes = b"0123456789abcdefABCDEF"
    names = [u1, u1[:-1] + str(int(u1[-1]) + 1), u1[:-1] + str(int(u1[-1]) + 2), u1[:-1] + str(int(u1[-1]) + 3)]
    for i in range(4):
        nxt = S[state] if i == 3 else S[names[i + 1]]
        for b in hex_bytes:
            trans[S[names[i]], b] = nxt


def _end_of_value(trans, stackop, state: int) -> None:
    """A value can be followed by ws, ',', or a closer."""
    for w in _WS:
        trans[state, w] = S["AFTER_VALUE"]
    trans[state, ord(",")] = SENT_COMMA
    trans[state, ord("}")] = SENT_CLOSE
    stackop[state, ord("}")] = OP_POP
    trans[state, ord("]")] = SENT_CLOSE
    stackop[state, ord("]")] = OP_POP


@lru_cache(maxsize=1)
def build_tables() -> JsonTables:
    trans = np.full((NUM_STATES, 256), -1, np.int16)
    stackop = np.zeros((NUM_STATES, 256), np.int8)

    for w in _WS:  # whitespace self-loops where structure permits
        for st in ("VALUE", "OBJ_OPEN", "ARR_OPEN", "AFTER_KEY", "AFTER_VALUE", "KEY_START", "DONE"):
            trans[S[st], w] = S[st]

    _value_starts(trans, stackop, S["VALUE"])
    _value_starts(trans, stackop, S["ARR_OPEN"])
    trans[S["ARR_OPEN"], ord("]")] = SENT_CLOSE
    stackop[S["ARR_OPEN"], ord("]")] = OP_POP

    # Object: key string then ':' then value.
    trans[S["OBJ_OPEN"], ord('"')] = S["KEY"]
    trans[S["OBJ_OPEN"], ord("}")] = SENT_CLOSE
    stackop[S["OBJ_OPEN"], ord("}")] = OP_POP
    trans[S["KEY_START"], ord('"')] = S["KEY"]

    _string_body(trans, "KEY", "KEY_ESC", "KEY_U1")
    trans[S["KEY"], ord('"')] = S["AFTER_KEY"]
    trans[S["AFTER_KEY"], ord(":")] = S["VALUE"]

    _string_body(trans, "STR", "STR_ESC", "STR_U1")
    trans[S["STR"], ord('"')] = S["AFTER_VALUE"]

    # Numbers (terminable mid-lex on delimiter/ws). Strict JSON: '0' takes no
    # further digits (leading zeros are invalid); '-' needs 0 or 1-9.
    trans[S["NUM_MINUS"], ord("0")] = S["NUM_ZERO"]
    for d in _DIGITS[1:]:
        trans[S["NUM_MINUS"], d] = S["NUM_INT"]
    for d in _DIGITS:
        trans[S["NUM_INT"], d] = S["NUM_INT"]
        trans[S["NUM_DOT"], d] = S["NUM_FRAC"]
        trans[S["NUM_FRAC"], d] = S["NUM_FRAC"]
        trans[S["NUM_ESIGN"], d] = S["NUM_EXP"]
        trans[S["NUM_EXP"], d] = S["NUM_EXP"]
    for st in ("NUM_ZERO", "NUM_INT"):
        trans[S[st], ord(".")] = S["NUM_DOT"]
        for e in b"eE":
            trans[S[st], e] = S["NUM_E"]
    for e in b"eE":
        trans[S["NUM_FRAC"], e] = S["NUM_E"]
    for sgn in b"+-":
        trans[S["NUM_E"], sgn] = S["NUM_ESIGN"]
    for d in _DIGITS:
        trans[S["NUM_E"], d] = S["NUM_EXP"]
    for st in ("NUM_ZERO", "NUM_INT", "NUM_FRAC", "NUM_EXP"):
        _end_of_value(trans, stackop, S[st])

    # Literals.
    for chain, bytes_ in (("T", b"rue"), ("F", b"alse"), ("N", b"ull")):
        steps = [f"{chain}{i+1}" for i in range(len(bytes_))]
        for i, b in enumerate(bytes_):
            nxt = S["AFTER_VALUE"] if i == len(bytes_) - 1 else S[steps[i + 1]]
            trans[S[steps[i]], b] = nxt

    # Also wires the ws self-loop: _end_of_value maps ws -> AFTER_VALUE.
    _end_of_value(trans, stackop, S["AFTER_VALUE"])

    closable = np.zeros(NUM_STATES, bool)
    for st in _CLOSABLE:
        closable[S[st]] = True
    closable[S["OBJ_OPEN"]] = True  # '{}'
    closable[S["ARR_OPEN"]] = True  # '[]'
    terminal = np.zeros(NUM_STATES, bool)
    for st in _TERMINAL:
        terminal[S[st]] = True

    return JsonTables(
        trans=trans,
        stackop=stackop,
        allowed=trans >= 0,
        closable=closable,
        terminal=terminal,
    )


# --- host-side validator (tests + non-jit callers) ------------------------

def validate_prefix(data: bytes, max_depth: int = 16) -> Tuple[bool, bool]:
    """Run the automaton over ``data``. Returns (is_valid_prefix, is_complete).
    The same tables the device uses — a differential oracle for the mask."""
    t = build_tables()
    state, depth = S["VALUE"], 0
    stack = [0] * max_depth
    for byte in data:
        nxt = int(t.trans[state, byte])
        if nxt < 0:
            return False, False
        if nxt == SENT_COMMA and depth == 0:
            return False, False  # ',' outside any container
        op = int(t.stackop[state, byte])
        if op == OP_PUSH_OBJ or op == OP_PUSH_ARR:
            if depth >= max_depth:
                return False, False
            stack[depth] = CTX_OBJ if op == OP_PUSH_OBJ else CTX_ARR
            depth += 1
        elif op == OP_POP:
            want = CTX_OBJ if byte == ord("}") else CTX_ARR
            if depth == 0 or stack[depth - 1] != want:
                return False, False
            depth -= 1
        if nxt == SENT_COMMA:
            state = S["KEY_START"] if (depth and stack[depth - 1] == CTX_OBJ) else S["VALUE"]
        elif nxt == SENT_CLOSE:
            state = S["DONE"] if depth == 0 else S["AFTER_VALUE"]
        else:
            state = nxt
    return True, bool(t.terminal[state]) and depth == 0


# --- device side (torch, no host sync) -----------------------------------

class DeviceTables(NamedTuple):
    trans: "object"     # [S, 256] int64 (device)
    stackop: "object"   # [S, 256] int64
    allowed: "object"   # [S, 256] bool
    closable: "object"  # [S] bool
    terminal: "object"  # [S] bool


@lru_cache(maxsize=8)
def device_tables(device="cpu") -> DeviceTables:
    import torch

    t = build_tables()
    return DeviceTables(
        trans=torch.as_tensor(t.trans, dtype=torch.int64, device=device),
        stackop=torch.as_tensor(t.stackop, dtype=torch.int64, device=device),
        allowed=torch.as_tensor(t.allowed, device=device),
        closable=torch.as_tensor(t.closable, device=device),
        terminal=torch.as_tensor(t.terminal, device=device),
    )


def initial_state(n: int, max_depth: int = 16, device="cpu"):
    """(state [n], depth [n], stack [n, max_depth]) before any byte."""
    import torch

    return (
        torch.full((n,), S["VALUE"], dtype=torch.int64, device=device),
        torch.zeros((n,), dtype=torch.int64, device=device),
        torch.zeros((n, max_depth), dtype=torch.int64, device=device),
    )


def mask_logits(t: DeviceTables, logits, state, depth, stack, eos_arr):
    """Apply the JSON mask to [n, V] logits. Byte columns 0..255 follow the
    automaton; EOS columns open only when the document is complete; everything
    else (other special tokens) is banned."""
    import torch

    from ._indexing import jax_rows, open_eos, take_last_axis

    n, V = logits.shape
    max_depth = stack.shape[1]
    st = jax_rows(state, t.allowed.shape[0])
    base = t.allowed[st]  # [n, 256]

    top = take_last_axis(stack, (depth - 1).clamp_min(0))
    has = depth > 0
    obj_ok = has & (top == CTX_OBJ)
    arr_ok = has & (top == CTX_ARR)
    cols = torch.arange(256, device=logits.device)
    # The stack-top check applies only where '}'/']' would actually POP — in
    # string states they are ordinary content bytes and stay unrestricted.
    pop_brace = t.stackop[st, ord("}")] == OP_POP  # [n]
    pop_brack = t.stackop[st, ord("]")] == OP_POP
    bad_brace = pop_brace & ~obj_ok
    bad_brack = pop_brack & ~arr_ok
    base = base & ~((cols[None, :] == ord("}")) & bad_brace[:, None])
    base = base & ~((cols[None, :] == ord("]")) & bad_brack[:, None])
    # ',' only continues a CONTAINER: at depth 0 there is nothing to separate.
    comma_trans = t.trans[st, ord(",")] == SENT_COMMA
    bad_comma = comma_trans & ~has
    base = base & ~((cols[None, :] == ord(",")) & bad_comma[:, None])
    # Depth guard: no further nesting at the stack limit. Gated on the byte
    # actually PUSHING (inside strings '{'/'[' are plain content bytes).
    full = depth >= max_depth
    push_brace = t.stackop[st, ord("{")] == OP_PUSH_OBJ
    push_brack = t.stackop[st, ord("[")] == OP_PUSH_ARR
    base = base & ~((cols[None, :] == ord("{")) & (push_brace & full)[:, None])
    base = base & ~((cols[None, :] == ord("[")) & (push_brack & full)[:, None])

    mask = torch.zeros((n, V), dtype=torch.bool, device=logits.device)
    mask[:, :256] = base[:, : min(256, V)]
    eos_ok = t.terminal[st] & (depth == 0)  # [n]
    open_eos(mask, eos_arr, eos_ok)
    return torch.where(mask, logits, torch.finfo(logits.dtype).min)


def advance(t: DeviceTables, token, state, depth, stack):
    """Step the automaton with the emitted token ([n] ids). Tokens >= 256
    (EOS/pad) freeze the row. Returns (state, depth, stack)."""
    import torch

    from ._indexing import jax_rows, take_last_axis

    max_depth = stack.shape[1]
    is_byte = token < 256
    byte = token.clamp(0, 255)
    st = jax_rows(state, t.trans.shape[0])
    nxt = t.trans[st, byte]
    op = t.stackop[st, byte]

    push = (op == OP_PUSH_OBJ) | (op == OP_PUSH_ARR)
    ctx = torch.where(op == OP_PUSH_OBJ, CTX_OBJ, CTX_ARR)
    slot = torch.arange(max_depth, device=depth.device)[None, :] == depth[:, None]
    stack = torch.where(slot & (push & is_byte)[:, None], ctx[:, None], stack)
    step = push.to(depth.dtype) - (op == OP_POP).to(depth.dtype)
    new_depth = depth + torch.where(is_byte, step, torch.zeros_like(step))

    # Sentinels resolve against the stack AFTER the op.
    top = take_last_axis(stack, (new_depth - 1).clamp_min(0))
    in_obj = (new_depth > 0) & (top == CTX_OBJ)
    nxt = torch.where(
        nxt == SENT_COMMA,
        torch.where(in_obj, S["KEY_START"], S["VALUE"]),
        nxt,
    )
    nxt = torch.where(
        nxt == SENT_CLOSE,
        torch.where(new_depth == 0, S["DONE"], S["AFTER_VALUE"]),
        nxt,
    )
    state = torch.where(is_byte, nxt, state)
    return state, torch.where(is_byte, new_depth, depth), stack
