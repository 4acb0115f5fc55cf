"""Ring decode against a SEQUENCE-SHARDED prefix on the port, held against
the JAX package (twins of ``tests/test_sp_decode.py``'s engine tests): a
gloo world of four port ranks on a (2, 2) mesh (ring of two over ``data``,
tensor parallel over ``model``) beside the JAX mesh of that shape. With
``sp_decode`` the SP prefill's KV stays in each rank's chunk, decode
attends it by ring attention, and the outputs equal the dense engine's."""

import jax
import numpy as np

from _torch_mesh import assert_same_on_ranks, jax_mesh, port_config, port_tree, world_fixture
from conftest import shared_engine, shared_params
from k_llms_tpu.engine.engine import GenRequestSpec
from k_llms_tpu.engine.engine import LocalEngine as JaxEngine
from k_llms_tpu.models import get_config

world = world_fixture(4)

CFG = get_config("tiny")
PROMPT = [int(x) for x in jax.random.randint(jax.random.key(40), (64,), 5, 200)]
SP = dict(sp_prefill_min_tokens=48, sp_decode=True)


def _run(world, calls, shape=(2, 2), key=None, **engine_kwargs):
    res = world.run("engine", shape=shape, config=port_config(CFG),
                    params=port_tree(shared_params(CFG), CFG),
                    engine_kwargs=dict(kv_page_size=8, **engine_kwargs), calls=calls, key=key)
    assert_same_on_ranks(res)
    return res


def _dense():
    return shared_engine("tiny")


def test_sp_decode_matches_dense(world):
    kw = dict(n=4, max_new_tokens=6, temperature=0.0, seed=11)
    want = _dense().generate(PROMPT, **kw)
    res = _run(world, [("collectives",), ("generate", (PROMPT,), kw), ("collectives",)],
               key="sp", **SP)[0]
    got, counts = res[1], res[2]
    assert counts["ppermute"] > 0  # the ring ran (prefill and decode)
    np.testing.assert_array_equal(got["tokens"], want.tokens)
    np.testing.assert_allclose(got["logprobs"], want.logprobs, atol=1e-5)
    assert got["finish_reasons"] == want.finish_reasons


def test_sp_decode_sampled_matches_dense(world):
    kw = dict(n=4, max_new_tokens=5, temperature=0.9, seed=23)
    want = _dense().generate(PROMPT, **kw)
    got = _run(world, [("generate", (PROMPT,), kw)], key="sp", **SP)[0][0]
    np.testing.assert_array_equal(got["tokens"], want.tokens)


def test_sp_decode_matches_jax_mesh_engine(world):
    """The JAX ring-decode engine on the same (2, 2) mesh: tokens and
    logprobs."""
    kw = dict(n=4, max_new_tokens=6, temperature=0.7, seed=5)
    want = JaxEngine(CFG, params=shared_params(CFG), mesh=jax_mesh(2, 2), **SP).generate(PROMPT, **kw)
    got = _run(world, [("generate", (PROMPT,), kw)], key="sp", **SP)[0][0]
    np.testing.assert_array_equal(got["tokens"], want.tokens)
    np.testing.assert_allclose(got["logprobs"], want.logprobs, atol=1e-5)


def test_sp_decode_prefix_stays_sequence_sharded(world):
    """The SP prefill's KV comes back as each rank's chunk of the sequence."""
    res = _run(world, [("fn", "prefill_full_layout", (PROMPT, 64))], key="sp", **SP)
    for r in res:
        assert r[0][:2] == ("SeqShardedKV", 32)


def test_short_prompts_keep_replicated_path(world):
    short = PROMPT[:20]
    kw = dict(n=2, max_new_tokens=4, temperature=0.0, seed=5)
    res = _run(world, [("fn", "prefill_full_layout", (short, 32)), ("generate", (short,), kw)],
               key="sp", **SP)[0]
    assert res[0][:2] == ("KVCache", 32)
    np.testing.assert_array_equal(res[1]["tokens"], _dense().generate(short, **kw).tokens)


def test_sp_decode_composes_with_prefix_cache_exact_hits(world):
    kw = dict(n=4, max_new_tokens=4, temperature=0.7, seed=13)
    r = _run(world, [("generate", (PROMPT,), kw), ("attr", "prefix_cache_stats"),
                     ("generate", (PROMPT,), kw), ("attr", "prefix_cache_stats")],
             prefix_cache_size=2, **SP)[0]
    assert r[1] == {"hits": 0, "partial_hits": 0, "misses": 1}
    assert r[3]["hits"] == 1
    np.testing.assert_array_equal(r[0]["tokens"], r[2]["tokens"])


def test_sp_exact_hit_ignores_replicated_layout_entry(world):
    """A replicated entry under the prompt's key is a miss for the ring
    route, overwritten by its sequence-sharded twin, which then hits."""
    kw = dict(n=4, max_new_tokens=4, temperature=0.0, seed=3)
    r = _run(world, [("fn", "plant_replicated", (PROMPT,)), ("generate", (PROMPT,), kw),
                     ("attr", "prefix_cache_stats"), ("fn", "entry_layout", (PROMPT,)),
                     ("generate", (PROMPT,), kw), ("attr", "prefix_cache_stats")],
             prefix_cache_size=2, **SP)[0]
    assert r[0] is False
    assert r[2]["hits"] == 0 and r[2]["misses"] == 1
    assert r[3] == (True, 32)
    np.testing.assert_array_equal(r[1]["tokens"], _dense().generate(PROMPT, **kw).tokens)
    assert r[5]["hits"] == 1


def test_seq_sharded_cache_entry_never_partial_matches(world):
    r = _run(world, [("generate", (PROMPT,), dict(n=4, max_new_tokens=2, temperature=0.5, seed=1)),
                     ("generate", (PROMPT[:20],), dict(n=2, max_new_tokens=2, temperature=0.5,
                                                        seed=2)),
                     ("attr", "prefix_cache_stats")],
             prefix_cache_size=2, prefix_cache_min_reuse=16, **SP)[0]
    assert r[2]["partial_hits"] == 0 and r[2]["misses"] == 2


def test_prefill_with_cache_labels_sp_entries_seq_sharded(world):
    longer = PROMPT + PROMPT[:32]
    r = _run(world, [("fn", "prefill_routed", (PROMPT, 64)), ("fn", "entry_layout", (PROMPT,)),
                     ("fn", "prefill_routed", (longer, 128)), ("attr", "prefix_cache_stats")],
             prefix_cache_size=2, prefix_cache_min_reuse=16, **SP)[0]
    assert r[1] == (True, 32)
    assert r[3]["partial_hits"] == 0 and r[3]["misses"] == 2


def test_generate_many_with_sp_decode_prefix_cache_bit_equal(world):
    items = [GenRequestSpec(prompt_ids=PROMPT, n=2, seed=7),
             GenRequestSpec(prompt_ids=PROMPT[:20], n=2, seed=9)]
    kw = dict(max_new_tokens=4, temperature=0.8)
    want = _dense().generate_many(items, **kw)
    got = _run(world, [("generate_many", ([tuple(it[:3]) for it in items],), kw)],
               prefix_cache_size=2, prefix_cache_min_reuse=16, **SP)[0][0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w.tokens)


def test_sp_partial_hit_continues_in_ring_layout(world):
    kw = dict(n=4, max_new_tokens=4, temperature=0.7, seed=13)
    longer = PROMPT + [int(x) for x in jax.random.randint(jax.random.key(7), (30,), 5, 200)]
    longest = longer + [int(x) for x in jax.random.randint(jax.random.key(8), (20,), 5, 200)]
    r = _run(world, [("generate", (PROMPT,), kw), ("generate", (longer,), kw),
                     ("attr", "prefix_cache_stats"), ("fn", "entry_layout", (longer,)),
                     ("generate", (longest,), kw), ("attr", "prefix_cache_stats")],
             prefix_cache_size=4, prefix_cache_min_reuse=16, **SP)[0]
    dense = _dense()
    np.testing.assert_array_equal(r[0]["tokens"], dense.generate(PROMPT, **kw).tokens)
    assert r[2]["partial_hits"] == 1 and r[2]["misses"] == 1
    np.testing.assert_array_equal(r[1]["tokens"], dense.generate(longer, **kw).tokens)
    assert r[3][0] is True
    assert r[5]["partial_hits"] == 2 and r[5]["misses"] == 1
    np.testing.assert_array_equal(r[4]["tokens"], dense.generate(longest, **kw).tokens)


def test_sp_continuation_crosses_bucket_boundary(world):
    kw = dict(n=4, max_new_tokens=3, temperature=0.6, seed=29)
    longer = PROMPT + [int(x) for x in jax.random.randint(jax.random.key(3), (80,), 5, 200)]
    r = _run(world, [("generate", (PROMPT,), kw), ("generate", (longer,), kw),
                     ("attr", "prefix_cache_stats"), ("fn", "entry_layout", (longer,))],
             prefix_cache_size=4, prefix_cache_min_reuse=16, **SP)[0]
    assert r[2]["partial_hits"] == 1
    np.testing.assert_array_equal(r[1]["tokens"], _dense().generate(longer, **kw).tokens)
    assert r[3] == (True, 128)  # 256 positions over the ring of two


def test_sp_continuation_logprobs_match_dense(world):
    kw = dict(n=2, max_new_tokens=4, temperature=0.0, seed=5)
    longer = PROMPT + [int(x) for x in jax.random.randint(jax.random.key(11), (25,), 5, 200)]
    r = _run(world, [("generate", (PROMPT,), kw), ("generate", (longer,), kw),
                     ("attr", "prefix_cache_stats")],
             prefix_cache_size=2, prefix_cache_min_reuse=16, **SP)[0]
    assert r[2]["partial_hits"] == 1
    want = _dense().generate(longer, **kw)
    np.testing.assert_array_equal(r[1]["tokens"], want.tokens)
    np.testing.assert_allclose(r[1]["logprobs"], want.logprobs, atol=1e-5)


def test_sp_resident_speculation_matches_sp_decode(world):
    """Speculation over a sequence-sharded prefix (verify by ring
    attention) reproduces the ring-decode engine's greedy tokens."""
    kw = dict(n=4, max_new_tokens=10, temperature=0.0, seed=3)
    plain = _run(world, [("generate", (PROMPT,), kw)], key="sp", **SP)[0][0]
    spec = _run(world, [("collectives",), ("generate", (PROMPT,), kw), ("collectives",)],
                speculative="prompt_lookup", spec_lookahead=4, **SP)[0]
    assert spec[2]["ppermute"] > 0
    np.testing.assert_array_equal(spec[1]["tokens"], plain["tokens"])
    assert spec[1]["spec_stats"]["verify_iterations"] >= 1
