"""Decode rows split over the data axis, held against the JAX package's mesh:
gloo worlds of two and four spawned port ranks (``_torch_mesh_worker``) on
the (2, 1) and (2, 2) meshes, beside the JAX mesh engine of the same shape on
the forced CPU devices. Tiny fp32 weights from the parity harness's seed.

A coalesced ``generate_many`` of three requests with n = 3 (n pads to 4, the
data axis's multiple, and the three requests to four: B = 16 rows), greedy
and seeded-sampled, paged and dense, and one grammar-constrained launch:
tokens exactly JAX's, logprobs within 1e-5, and each rank decoded B/D = 8
rows (``last_launch_stats["rank_rows"]``). Every rank returns the whole
gathered result."""

import numpy as np
import pytest

from _torch_mesh import port_config, port_tree
from _torch_mesh_worker import World
from conftest import shared_engine, shared_params
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.models import get_config

TINY = get_config("tiny")
PROMPTS = [list(range(5, 45)), list(range(60, 75)), list(range(100, 160))]
SEEDS = [7, 8, 9]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One gloo world per size, made on first use and kept for the file."""
    made = {}

    def get(size):
        if size not in made:
            made[size] = World(size, tmp_path_factory.mktemp(f"rows{size}"),
                               env={"KLLMS_RANK_CHECK": "1"})
        return made[size]

    yield get
    for w in made.values():
        w.close()


def _port(worlds, shape, kw, engine_kwargs):
    world = worlds(shape[0] * shape[1])
    res = world.run("engine", shape=shape, config=port_config(TINY),
                    params=port_tree(shared_params(TINY), TINY),
                    engine_kwargs=dict(kv_page_size=8, **engine_kwargs),
                    calls=[("generate_many", ([(p, 3, s) for p, s in zip(PROMPTS, SEEDS)],), kw),
                           ("attr", "last_launch_stats")],
                    key=("rows", shape, tuple(sorted(engine_kwargs.items()))))
    return res


def _jax(shape, kw):
    eng = shared_engine("tiny", mesh_shape=shape)
    return eng.generate_many([JaxSpec(p, 3, s) for p, s in zip(PROMPTS, SEEDS)], **kw)


def _check(res, ref, D=2):
    for rank, (out, stats) in enumerate(res):
        assert stats["rows"] == 16 and stats["n_per"] == 4
        assert stats["rank_rows"] == 16 // D, (rank, stats)
        for got, want in zip(out, ref):
            np.testing.assert_array_equal(got["tokens"], want.tokens)
            np.testing.assert_allclose(got["logprobs"], want.logprobs, atol=1e-5, rtol=0)
            assert got["finish_reasons"] == want.finish_reasons


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_coalesced_rows_split_over_data_match_jax_mesh(worlds, shape, layout, temperature):
    """Each data rank decodes its B/D rows (draws, stops and per-row state
    its own), and the gathered launch equals the JAX mesh engine's."""
    kw = dict(max_new_tokens=6, temperature=temperature)
    res = _port(worlds, shape, kw, dict(kv_layout=layout))
    _check(res, _jax(shape, kw))


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_constrained_rows_split_over_data_match_jax_mesh(worlds, shape):
    """A grammar-constrained coalesced launch: each rank's rows carry their
    own automaton states; the JAX mesh engine's tokens."""
    from k_llms_tpu.engine import grammar as jgrammar
    from k_llms_tpu_torch.engine import grammar as tgrammar
    from test_torch_grammar import BYTE_VOCAB, TOK, TRUTH_DOCS, _schema_of

    schema = _schema_of(TRUTH_DOCS["invoice"])
    jg = jgrammar.grammar_for_schema(schema, BYTE_VOCAB, vocab_digest="bytetok-test")
    tg = tgrammar.grammar_for_schema(schema, BYTE_VOCAB, vocab_digest="bytetok-test")
    kw = dict(max_new_tokens=12, temperature=0.7, eos_ids=TOK.stop_ids)
    res = _port(worlds, shape, dict(kw, constraint=tg), dict(kv_layout="paged"))
    ref = _jax(shape, dict(kw, constraint=jg))
    _check(res, ref)


def test_row_share_layouts():
    """Data coordinate d holds rows [d*B/D, (d+1)*B/D): whole requests, a
    request's run of samples, or (D not a power of two) a group per row."""
    from k_llms_tpu_torch.engine.engine import row_share

    assert row_share(16, 4, 2, 1) == (8, 16, [2, 3], 4)
    assert row_share(8, 8, 2, 1) == (4, 8, [0], 4)
    assert row_share(6, 3, 3, 1) == (2, 4, [0, 1], 1)
    assert row_share(16, 4, 1, 0) == (0, 16, [0, 1, 2, 3], 4)
