"""Seeded draws: the port's threefry2x32, ``fold_in``, key data and uniform
conversion (``k_llms_tpu_torch/ops/random.py``) held bit for bit against
``jax.random`` (with ``jax_threefry_partitionable``, the JAX package's
setting), the Gumbel noise within 1e-6, and sampled decoding on tiny fp32
through both engines: the JAX package's and the port's, on both KV layouts,
with the same seeds.

The Gumbel values come from two ``log`` implementations, so a sampled token
may differ where two perturbed scores tie to an ulp or so. A sample that
differs must first differ at a step where JAX's top two perturbed scores lie
within 1e-4; such samples are counted and the count is reported
(``test_sampled_tokens_equal_jax_engine`` prints it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from conftest import shared_engine, shared_params
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.models import get_config as jax_get_config
from k_llms_tpu.models import llama as jax_llama
from k_llms_tpu_torch.engine.engine import GenRequestSpec, LocalEngine
from k_llms_tpu_torch.models import llama
from k_llms_tpu_torch.models.config import get_config
from k_llms_tpu_torch.ops import _ext
from k_llms_tpu_torch.ops import random as rnd
from k_llms_tpu_torch.ops import sampling

SEEDS = [0, 7, 12345, 3000000000, 2 ** 32 - 1]
TINY = float(np.finfo(np.float32).tiny)
STEP_ROWS = [(0, 0), (5, 3), (63, 7), (1, 0)]


def _jax_row_key(seed, step, row):
    return jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), step), row)


def test_jax_threefry_is_partitionable():
    """The counter layout the port reproduces is the partitionable one."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_key_data_and_fold_in_equal_jax(seed):
    np.testing.assert_array_equal(
        rnd.key_data(seed).numpy(), np.asarray(jax.random.key_data(jax.random.key(seed)))
    )
    rng = np.random.default_rng(seed % 1000)
    k = rng.integers(0, 2 ** 32, size=2, dtype=np.uint64)
    x = rng.integers(0, 2 ** 32, size=(2, 64), dtype=np.uint64)
    ref = np.asarray(jax_prng.threefry_2x32(
        jnp.asarray(k.astype(np.uint32)), jnp.asarray(x.astype(np.uint32).reshape(-1))
    )).reshape(2, 64)
    y0, y1 = rnd.threefry2x32(*(torch.tensor(np.asarray(a, np.int64)) for a in (k[0], k[1], x[0], x[1])))
    np.testing.assert_array_equal(np.stack([y0.numpy(), y1.numpy()]), ref.astype(np.int64))
    for step, row in STEP_ROWS:
        ours = rnd.fold_in(rnd.fold_in(rnd.key_data(seed), step), row)
        np.testing.assert_array_equal(
            ours.numpy(), np.asarray(jax.random.key_data(_jax_row_key(seed, step, row)))
        )


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits_equal_jax_and_gumbel_within_1e_6(seed):
    V = 1000
    for step, row in STEP_ROWS:
        key = _jax_row_key(seed, step, row)
        ours = rnd.fold_in(rnd.fold_in(rnd.key_data(seed), step), row)
        np.testing.assert_array_equal(
            rnd.random_bits(ours, V).numpy(), np.asarray(jax.random.bits(key, (V,))).astype(np.int64)
        )
        u = rnd.uniform_tiny(ours, V).numpy()
        ref = np.asarray(jax.random.uniform(key, (V,), minval=TINY, maxval=1.0))
        np.testing.assert_array_equal(u.view(np.uint32), ref.view(np.uint32))
        gumbel = -np.log(-np.log(u.astype(np.float32)))
        torch_gumbel = (-torch.log(-torch.log(torch.from_numpy(u)))).numpy()
        jax_gumbel = np.asarray(jax.random.gumbel(key, (V,)))
        np.testing.assert_allclose(torch_gumbel, jax_gumbel, atol=1e-6, rtol=0)
        np.testing.assert_allclose(gumbel, jax_gumbel, atol=1e-6, rtol=0)


def test_row_keys_are_request_major_like_the_jax_engine():
    """The engine's rows: ``fold_in(fold_in(key(seed_j), step), i)`` for row
    i of request j, with the step folded first."""
    seeds, n_per, step = [7, 3000000000, 0], 3, 9
    ours = rnd.row_keys(rnd.request_keys(seeds, "cpu"), step, n_per).numpy()
    ref = np.stack([np.asarray(jax.random.key_data(_jax_row_key(s, step, i)))
                    for s in seeds for i in range(n_per)])
    np.testing.assert_array_equal(ours, ref)


def test_draw_noise_on_cpu_runs_the_plain_version():
    """On CPU tensors the kernel wrapper runs the plain version (no launch
    counted), with the step read from a 0-d int32 tensor."""
    keys = rnd.request_keys([5, 6], "cpu")
    step = torch.tensor(4, dtype=torch.int32)
    before = dict(_ext.LAUNCH_COUNTS)
    noise = sampling.draw_noise(keys, step, 2, 300)
    assert _ext.LAUNCH_COUNTS == before
    ref = np.stack([np.asarray(jax.random.uniform(_jax_row_key(s, 4, i), (300,), minval=TINY))
                    for s in (5, 6) for i in range(2)])
    np.testing.assert_array_equal(noise.numpy().view(np.uint32), ref.view(np.uint32))


def test_per_row_uniforms_equal_jax():
    """The continuous loop's draws: each row with its own seed, step and
    sample index, ``fold_in(fold_in(key(seed_r), step_r), index_r)``, bit
    for bit (the plain version, which the CPU wrapper runs uncounted)."""
    seeds = [7, 3000000000, 0, 2 ** 32 - 1, 12345]
    steps = [1, 0, 63, 17, 5]
    index = [0, 3, 7, 1, 2]
    keys = rnd.request_keys(seeds, "cpu")
    before = dict(_ext.LAUNCH_COUNTS)
    got = rnd.threefry_uniform_rows(keys, torch.tensor(steps, dtype=torch.int32),
                                    torch.tensor(index, dtype=torch.int32), 300)
    assert _ext.LAUNCH_COUNTS == before
    ref = np.stack([np.asarray(jax.random.uniform(_jax_row_key(s, st, i), (300,), minval=TINY))
                    for s, st, i in zip(seeds, steps, index)])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))


# --- sampled decoding: the JAX engine against the port's ---------------------

PROMPT = [256] + list(b"draw some tokens")
SAMPLED = dict(max_new_tokens=10, temperature=1.0, top_p=0.9, top_k=20)
ENGINE_SEEDS = list(range(8))
TIE = 1e-4


@pytest.fixture(scope="module")
def tiny_weights():
    jax_params = shared_params(jax_get_config("tiny"), 0)
    return jax_params, llama.params_from_numpy(jax.device_get(jax_params), get_config("tiny"))


def _near_tie(jax_params, tokens, step, seed, row):
    """Whether JAX's top two perturbed scores at draw ``step`` of this row
    (after the same prefix) lie within ``TIE``: the logits from a JAX
    prefill of the prompt and the row's tokens before ``step``."""
    jcfg = jax_get_config("tiny")
    ids = PROMPT + [int(t) for t in tokens[:step]]
    bucket = 64
    toks = np.array([ids + [jcfg.pad_token_id] * (bucket - len(ids))], np.int32)
    logits, _ = jax_llama.prefill(jcfg, jax_params, jnp.asarray(toks), jnp.int32(len(ids)))
    logits = torch.from_numpy(np.asarray(logits, np.float32))
    logits[:, jcfg.pad_token_id] = -float("inf")
    sl = sampling.filter_logits(sampling.sanitize_logits(logits) / SAMPLED["temperature"],
                                SAMPLED["top_p"], SAMPLED["top_k"])[0].numpy()
    g = np.asarray(jax.random.gumbel(_jax_row_key(seed, step, row), (sl.shape[0],)))
    top2 = np.sort(sl + g)[-2:]
    return bool(top2[1] - top2[0] < TIE)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sampled_tokens_equal_jax_engine(tiny_weights, layout):
    """temperature 1.0, top_p 0.9, top_k 20, n=4, seeds 0-7: tokens equal
    to the JAX engine's, up to the near-tie accounting."""
    jax_params, params = tiny_weights
    jeng = shared_engine("tiny", **({"kv_layout": "paged"} if layout == "paged" else {}))
    teng = LocalEngine(get_config("tiny"), params=params, device="cpu", kv_layout=layout,
                       kv_page_size=8)
    near_ties, compared = 0, 0
    for seed in ENGINE_SEEDS:
        j = jeng.generate_many([JaxSpec(PROMPT, 4, seed)], **SAMPLED)[0]
        t = teng.generate_many([GenRequestSpec(PROMPT, 4, seed)], **SAMPLED)[0]
        assert teng.last_launch_stats["kv_layout"] == layout
        for row in range(4):
            compared += 1
            diff = np.flatnonzero(j.tokens[row] != t.tokens[row])
            if diff.size == 0:
                np.testing.assert_allclose(t.logprobs[row], j.logprobs[row], atol=1e-5, rtol=0)
                continue
            step = int(diff[0])
            assert _near_tie(jax_params, j.tokens[row], step, seed, row), (
                f"seed {seed} row {row}: first differs at step {step}, not at a near-tie")
            near_ties += 1
    print(f"\nsampled tiny fp32 ({layout}): {near_ties} of {compared} samples differ at a near-tie")
    assert len({tuple(r) for r in t.tokens}) > 1  # the draws differ between rows
