"""Grammar-constrained decoding in the port held against the JAX package.

- The four automata's device ops (the JSON stack machine, the schema DFA,
  the BPE token table and the compiled grammar, with and without
  ``pad_states``): masked logits and advanced states bit-equal to the JAX
  functions over random states and logits (dead and out-of-range states,
  depths past the stack), and over token streams that mix legal tokens with
  pad, EOS and out-of-vocabulary ids.
- The compiled arrays of ``grammar_for_schema`` equal the JAX package's for
  the three TRUTH_DOCS schemas and for an unsupported schema (which falls
  back to the generic JSON grammar).
- Constrained greedy decoding on tiny fp32 emits the JAX engine's tokens on
  both KV layouts, and every sample is mask-legal (the twin of
  ``tests/test_grammar.py::test_constrained_greedy_parses_under_every_truth_schema``).
- Through the client: ``parse()`` decodes constrained by default, and
  ``constrained_decoding=False`` gives exactly the output of no
  ``response_format`` (the twin of ``tests/test_grammar.py:250``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from pydantic import BaseModel

from conftest import shared_engine, shared_params
from k_llms_tpu.engine import grammar as jgrammar
from k_llms_tpu.engine import json_constraint as jjson
from k_llms_tpu.engine import schema_constraint as jschema
from k_llms_tpu.engine import token_constraint as jtoken
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.models import get_config as jax_get_config
from k_llms_tpu.utils.quality import TRUTH_DOCS
from k_llms_tpu_torch.engine import grammar as tgrammar
from k_llms_tpu_torch.engine import json_constraint as tjson
from k_llms_tpu_torch.engine import schema_constraint as tschema
from k_llms_tpu_torch.engine import token_constraint as ttoken
from k_llms_tpu_torch.engine.engine import GenRequestSpec, LocalEngine
from k_llms_tpu_torch.engine.tokenizer import ByteTokenizer
from k_llms_tpu_torch.models import llama
from k_llms_tpu_torch.models.config import get_config
from k_llms_tpu_torch.utils.observability import GRAMMAR_EVENTS

TOK = ByteTokenizer()
BYTE_VOCAB = tgrammar.grammar_vocab(TOK)
# A BPE-like vocabulary: the bytes, multi-byte pieces that cross JSON
# structure, one token longer than MAX_TOKEN_BYTES (banned), then specials.
BPE_VOCAB = (
    [bytes([i]) for i in range(256)]
    + [b'{"', b'":', b'",', b'"}', b'":"', b"name", b"count", b"true", b"false", b"null",
       b"12", b"0.5", b"  ", b'{"name":"', b'","count":', b"a" * 40, b"]}", b"[1,"]
    + [None] * 26
)
EOS = [TOK.eos_id, -1, 5000, -3]  # an id past the logits clips to the last column


class Record(BaseModel):
    name: str
    count: int


def _schema_of(value):
    """Structural JSON schema of a truth document (as tests/test_grammar.py)."""
    if isinstance(value, bool):
        return {"type": "boolean"}
    if isinstance(value, int):
        return {"type": "integer"}
    if isinstance(value, float):
        return {"type": "number"}
    if isinstance(value, str):
        return {"type": "string"}
    if isinstance(value, list):
        return {"type": "array", "items": _schema_of(value[0])}
    if isinstance(value, dict):
        return {
            "type": "object",
            "properties": {k: _schema_of(v) for k, v in value.items()},
            "required": list(value),
            "additionalProperties": False,
        }
    raise TypeError(type(value))


UNSUPPORTED = {"type": "object", "patternProperties": {"a": {"type": "string"}}}


# --- the four automata: device ops bit-equal ------------------------------

class _Pair:
    """One automaton's JAX and torch device ops, with random-state makers."""

    def __init__(self, kind, pad_states=0):
        self.kind = kind
        schema = Record.model_json_schema()
        if kind == "json":
            self.jt, self.tt = jjson.device_tables(), tjson.device_tables("cpu")
            self.n_states, self.vocab = jjson.NUM_STATES, 256
            self.jmask, self.tmask = jjson.mask_logits, tjson.mask_logits
            self.jadv, self.tadv = jjson.advance, tjson.advance
        elif kind == "schema":
            dfa = jschema.compile_schema(schema)
            self.jt, self.tt = jschema.device_dfa(dfa), tschema.device_dfa(tschema.compile_schema(schema))
            self.n_states, self.vocab = dfa.trans.shape[0], 256
            self.jmask, self.tmask = jschema.dfa_mask_logits, tschema.dfa_mask_logits
            self.jadv, self.tadv = jschema.dfa_advance, tschema.dfa_advance
        elif kind == "token":
            jtc = jtoken.schema_token_constraint(jschema.compile_schema(schema), BPE_VOCAB)
            ttc = ttoken.schema_token_constraint(tschema.compile_schema(schema), BPE_VOCAB)
            self.jt, self.tt = jtoken.device_token_table(jtc), ttoken.device_token_table(ttc)
            self.n_states, self.vocab = jtc.trans.shape[0], len(BPE_VOCAB)
            self.jmask, self.tmask = jtoken.token_mask_logits, ttoken.token_mask_logits
            self.jadv, self.tadv = jtoken.token_advance, ttoken.token_advance
        else:
            jg = jgrammar.grammar_for_schema(schema, BPE_VOCAB, vocab_digest="bpe-test")
            tg = tgrammar.grammar_for_schema(schema, BPE_VOCAB, vocab_digest="bpe-test")
            self.jt = jgrammar.device_grammar(jg, pad_states=pad_states)
            self.tt = tgrammar.device_grammar(tg, pad_states=pad_states)
            self.n_states, self.vocab = self.jt.trans.shape[0], len(BPE_VOCAB)
            self.jmask, self.tmask = jgrammar.grammar_mask_logits, tgrammar.grammar_mask_logits
            self.jadv, self.tadv = jgrammar.grammar_advance, tgrammar.grammar_advance

    def start(self, n):
        if self.kind == "json":
            j = jjson.initial_state(n)
            return j, tjson.initial_state(n)
        init = {"schema": (jschema.dfa_initial_state, tschema.dfa_initial_state),
                "token": (jtoken.token_initial_state, ttoken.token_initial_state),
                "grammar": (jgrammar.grammar_initial_state, tgrammar.grammar_initial_state)}
        ji, ti = init[self.kind]
        return (ji(self.jt, n),), (ti(self.tt, n),)

    def random_states(self, rng, n):
        """Live, dead (-1) and out-of-range states; for JSON also depths
        below 0 and past the stack, and random stack contents."""
        st = rng.integers(-2, self.n_states + 2, size=n)
        if self.kind != "json":
            return (jnp.asarray(st, jnp.int32),), (torch.as_tensor(st),)
        depth = rng.integers(-1, 19, size=n)
        stack = rng.integers(0, 3, size=(n, 16))
        return ((jnp.asarray(st, jnp.int32), jnp.asarray(depth, jnp.int32),
                 jnp.asarray(stack, jnp.int32)),
                (torch.as_tensor(st), torch.as_tensor(depth), torch.as_tensor(stack)))

    def mask(self, logits, jst, tst):
        j = np.asarray(self.jmask(self.jt, jnp.asarray(logits), *jst, jnp.asarray(EOS, jnp.int32)))
        t = self.tmask(self.tt, torch.from_numpy(logits), *tst, torch.as_tensor(EOS)).numpy()
        return j, t

    def advance(self, tokens, jst, tst):
        j = self.jadv(self.jt, jnp.asarray(tokens, jnp.int32), *jst)
        t = self.tadv(self.tt, torch.as_tensor(tokens, dtype=torch.int64), *tst)
        if self.kind != "json":
            j, t = (j,), (t,)
        return tuple(j), tuple(t)


def _assert_states_equal(jst, tst):
    for a, b in zip(jst, tst):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(np.int64))


AUTOMATA = [("json", 0), ("schema", 0), ("token", 0), ("grammar", 0), ("grammar", 64)]


@pytest.mark.parametrize("kind,pad_states", AUTOMATA)
def test_mask_and_advance_bit_equal_jax_over_random_states(kind, pad_states):
    pair = _Pair(kind, pad_states)
    rng = np.random.default_rng(hash(kind) % 1000 + pad_states)
    n, V = 48, pair.vocab + 40
    jst, tst = pair.random_states(rng, n)
    logits = rng.standard_normal((n, V), dtype=np.float32) * 4
    j, t = pair.mask(logits, jst, tst)
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
    tokens = rng.integers(-3, V + 8, size=n)
    tokens[:4] = [TOK.eos_id, TOK.pad_id, V + 100, pair.vocab]
    _assert_states_equal(*pair.advance(tokens, jst, tst))


@pytest.mark.parametrize("kind,pad_states", AUTOMATA)
def test_mask_and_advance_bit_equal_jax_over_token_streams(kind, pad_states):
    """From the start state: each step masks, then picks a legal token for
    most rows and a stray one (pad, EOS, out of vocabulary, a banned byte)
    for the rest, and advances; masks and states stay bit-equal."""
    pair = _Pair(kind, pad_states)
    rng = np.random.default_rng(7 + pad_states)
    n, V = 16, pair.vocab + 20
    jst, tst = pair.start(n)
    logits = rng.standard_normal((n, V), dtype=np.float32)
    for _ in range(40):
        j, t = pair.mask(logits, jst, tst)
        np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
        legal = j > np.finfo(np.float32).min
        tokens = np.array([rng.choice(np.flatnonzero(row)) if row.any() else TOK.pad_id
                           for row in legal])
        stray = rng.random(n) < 0.2
        tokens[stray] = rng.choice([TOK.eos_id, TOK.pad_id, V + 3, -1, 0x01, 0x7F], size=stray.sum())
        jst, tst = pair.advance(tokens, jst, tst)
        _assert_states_equal(jst, tst)


# --- compiled arrays equal -------------------------------------------------

@pytest.mark.parametrize("name", ["invoice", "purchase_order", "profile", "unsupported"])
def test_compiled_grammar_arrays_equal_jax(name):
    schema = UNSUPPORTED if name == "unsupported" else _schema_of(TRUTH_DOCS[name])
    jgrammar.clear_grammar_cache()
    tgrammar.clear_grammar_cache()
    before = GRAMMAR_EVENTS.snapshot()
    jg = jgrammar.grammar_for_schema(schema, BYTE_VOCAB)
    tg = tgrammar.grammar_for_schema(schema, BYTE_VOCAB)
    assert isinstance(tg, tgrammar.CompiledGrammar)
    for field in ("masks", "trans", "terminal", "token_bytes", "token_len"):
        a, b = getattr(jg, field), getattr(tg, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(b, a)
    assert (tg.start, tg.digest, tg.vocab_size) == (jg.start, jg.digest, jg.vocab_size)
    after = GRAMMAR_EVENTS.snapshot()
    fell_back = after.get("grammar.fallback_unsupported", 0) - before.get("grammar.fallback_unsupported", 0)
    assert fell_back == (name == "unsupported")
    assert tg.digest.startswith("grammar-json-") == (name == "unsupported")
    # A second request for the same schema is a cache hit.
    assert tgrammar.grammar_for_schema(schema, BYTE_VOCAB) is tg
    assert tgrammar.grammar_cache_stats()["hits"] >= 1


# --- constrained greedy decode: tokens equal the JAX engine's --------------

def _prompt():
    return TOK.apply_chat_template([{"role": "user", "content": "extract the record"}])


@pytest.fixture(scope="module")
def tiny_params():
    jax_params = shared_params(jax_get_config("tiny"), 0)
    return llama.params_from_numpy(jax.device_get(jax_params), get_config("tiny"))


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("doc", ["invoice", "purchase_order", "profile"])
def test_constrained_greedy_tokens_equal_jax_engine(tiny_params, doc, layout):
    schema = _schema_of(TRUTH_DOCS[doc])
    dfa = tschema.compile_schema(schema)
    jg = jgrammar.grammar_for_schema(schema, BYTE_VOCAB, vocab_digest="bytetok-test")
    tg = tgrammar.grammar_for_schema(schema, BYTE_VOCAB, vocab_digest="bytetok-test")
    jeng = shared_engine("tiny", **({"kv_layout": "paged"} if layout == "paged" else {}))
    teng = LocalEngine(get_config("tiny"), params=tiny_params, device="cpu", kv_layout=layout,
                       kv_page_size=16)
    kw = dict(max_new_tokens=96, temperature=0.0, eos_ids=TOK.stop_ids)
    j = jeng.generate_many([JaxSpec(_prompt(), 2, 1)], constraint=jg, **kw)[0]
    t = teng.generate_many([GenRequestSpec(_prompt(), 2, 1)], constraint=tg, **kw)[0]
    np.testing.assert_array_equal(t.tokens, j.tokens)
    np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-5, rtol=0)
    assert t.finish_reasons == j.finish_reasons
    for i in range(2):
        body = [int(x) for x in t.tokens[i][: int(t.lengths[i])] if x < 256]
        assert tgrammar.validate_grammar_tokens(tg, body)[0], bytes(body)
        assert tschema.validate_bytes(dfa, bytes(body))[0]
        if t.finish_reasons[i] == "stop":
            assert tschema.validate_bytes(dfa, bytes(body))[1]
            json.loads(bytes(body))


def test_sampled_constrained_tokens_equal_jax_engine(tiny_params):
    """The mask, then the seeded draw: a sampled constrained request (the
    JSON automaton, n=3) emits the JAX engine's tokens."""
    jeng = shared_engine("tiny")
    teng = LocalEngine(get_config("tiny"), params=tiny_params, device="cpu", kv_layout="dense")
    kw = dict(max_new_tokens=24, temperature=1.0, top_k=40, eos_ids=TOK.stop_ids,
              constraint="json")
    j = jeng.generate_many([JaxSpec(_prompt(), 3, 11)], **kw)[0]
    t = teng.generate_many([GenRequestSpec(_prompt(), 3, 11)], **kw)[0]
    np.testing.assert_array_equal(t.tokens, j.tokens)
    for i in range(3):
        body = bytes(int(x) for x in t.tokens[i][: int(t.lengths[i])] if x < 256)
        assert tjson.validate_prefix(body)[0], body


def test_unknown_constraint_and_byte_eos_are_rejected(tiny_params):
    teng = LocalEngine(get_config("tiny"), params=tiny_params, device="cpu")
    with pytest.raises(ValueError, match="Unknown constraint"):
        teng.generate(_prompt(), n=1, max_new_tokens=2, constraint="yaml")
    with pytest.raises(ValueError, match="byte-level"):
        teng.generate(_prompt(), n=1, max_new_tokens=2, constraint="json", eos_ids=[10])


# --- through the client ----------------------------------------------------

def test_parse_is_constrained_by_default():
    from k_llms_tpu_torch import KLLMs

    tgrammar.clear_grammar_cache()
    client = KLLMs(backend="cuda", model="tiny", device="cpu")
    before = GRAMMAR_EVENTS.snapshot()
    seen = []
    generate_many = client.backend.engine.generate_many

    def spy(items, **kw):
        seen.append(kw.get("constraint"))
        return generate_many(items, **kw)

    client.backend.engine.generate_many = spy
    r = client.chat.completions.parse(messages=[{"role": "user", "content": "extract"}],
                                      response_format=Record, n=2, temperature=0.0,
                                      max_tokens=48, seed=5)
    assert len(r.choices) == 3
    g = seen[0]
    assert isinstance(g, tgrammar.CompiledGrammar)
    after = GRAMMAR_EVENTS.snapshot()
    assert after.get("grammar.miss", 0) - before.get("grammar.miss", 0) == 1
    for c in r.choices[1:]:
        ok, _ = tgrammar.validate_grammar_tokens(g, list(c.message.content.encode()))
        assert ok, c.message.content


def test_constrained_decoding_off_is_byte_identical_to_no_response_format():
    from k_llms_tpu_torch.backends.base import ChatRequest
    from k_llms_tpu_torch.backends.cuda import BackendConfig, CudaBackend

    msgs = [{"role": "user", "content": "say something"}]

    def run(config_kwargs, req_kwargs):
        backend = CudaBackend(config=BackendConfig(model="tiny", max_new_tokens=24, device="cpu",
                                                   **config_kwargs))
        req = ChatRequest(messages=msgs, model="tiny", n=3, seed=17, temperature=0.9,
                          **req_kwargs)
        return [c.message.content for c in backend.chat_completion(req).choices]

    plain = run({}, {})
    off = run({"constrained_decoding": False}, {"response_format": {"type": "json_object"}})
    on = run({}, {"response_format": {"type": "json_object"}})
    assert off == plain
    assert on != plain
    for text in on:
        assert tjson.validate_prefix(text.encode())[0], text
