"""Sampling: the port's keep-sets (top-k, top-p bisection) equal the JAX
package's ``sample_logits``; greedy tokens and logprobs equal; seeded draws
are self-deterministic and independent of coalescing.

The seeded draws themselves (JAX's threefry bits, and sampled tokens equal
to the JAX engine's) are held in ``tests/test_torch_random.py``. The JAX
keep-set is read by replacing ``jax.random.categorical`` with a function
that returns each row's kept-token bitmask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k_llms_tpu.ops import sampling as jax_sampling
from k_llms_tpu_torch.engine.engine import GenRequestSpec, LocalEngine
from k_llms_tpu_torch.ops import sampling

V = 24  # the bitmask fits an int32


def _jax_keep_mask(monkeypatch, logits, temperature, top_p, top_k):
    bits = jnp.asarray(1 << np.arange(V), jnp.int32)

    def fake_categorical(key, l):
        return jnp.sum(jnp.where(jnp.isfinite(l), bits, 0))

    monkeypatch.setattr(jax.random, "categorical", fake_categorical)
    toks, _ = jax_sampling.sample_logits(
        jnp.asarray(logits), jax.random.key(0), temperature=temperature, top_p=top_p, top_k=top_k
    )
    monkeypatch.undo()
    masks = np.asarray(toks).astype(np.int64)
    return (masks[:, None] >> np.arange(V)[None, :]) & 1 == 1


@pytest.mark.parametrize(
    "temperature,top_p,top_k",
    [(1.0, 0.9, None), (0.7, 0.5, None), (1.3, 0.99, None), (1.0, None, 5),
     (0.8, 0.95, 8), (1.0, 0.0, None), (1.0, 1.0, None)],
)
def test_keep_sets_equal_jax(monkeypatch, temperature, top_p, top_k):
    rng = np.random.default_rng(int(temperature * 10) + (top_k or 0))
    logits = (rng.standard_normal((16, V)) * 3).astype(np.float32)
    logits[0, :4] = logits[0, 4]  # ties at the boundary
    logits[1, 3] = -np.inf  # a masked entry
    logits[2] = np.nan  # a poisoned row: sanitised to uniform
    ref = _jax_keep_mask(monkeypatch, logits, temperature, top_p, top_k)
    sl = sampling.sanitize_logits(torch.from_numpy(logits)) / temperature
    keep = torch.isfinite(sampling.filter_logits(sl, top_p, top_k)).numpy()
    np.testing.assert_array_equal(keep, ref)


def test_greedy_tokens_and_logprobs_equal_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((8, 300)).astype(np.float32)
    logits[5, :] = np.inf  # poisoned row
    penalty = rng.standard_normal((8, 300)).astype(np.float32)
    jt, jl = jax_sampling.sample_logits(jnp.asarray(logits), None, temperature=0.0,
                                        penalty=jnp.asarray(penalty))
    tt, tl = sampling.sample_logits(torch.from_numpy(logits), temperature=0.0,
                                    penalty=torch.from_numpy(penalty))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    ji, jv = jax_sampling.model_top_logprobs(jnp.asarray(logits), 3)
    ti, tv = sampling.model_top_logprobs(torch.from_numpy(logits), 3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    ok = np.isfinite(logits).all(axis=1)
    np.testing.assert_array_equal(ti.numpy()[ok], np.asarray(ji)[ok])


def test_samples_stay_in_keep_set():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((64, V)).astype(np.float32))
    keep = torch.isfinite(sampling.filter_logits(logits, 0.6, None))
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        noise = torch.rand((64, V), generator=gen)
        toks, _ = sampling.sample_logits(logits, temperature=1.0, top_p=0.6, noise=noise)
        assert keep[torch.arange(64), toks].all()


@pytest.fixture(scope="module")
def engine():
    return LocalEngine("tiny", param_seed=0, device="cpu", kv_page_size=8)


def test_seeded_sampling_is_self_deterministic(engine):
    prompt = [256] + list(b"sample me")
    kw = dict(max_new_tokens=8, temperature=0.9, top_p=0.9)
    a = engine.generate(prompt, n=4, seed=11, **kw)
    b = engine.generate(prompt, n=4, seed=11, **kw)
    c = engine.generate(prompt, n=4, seed=12, **kw)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.logprobs, b.logprobs)
    assert not np.array_equal(a.tokens, c.tokens)
    assert len({tuple(r) for r in a.tokens}) > 1  # the n samples differ


def test_request_samples_independent_of_coalescing(engine):
    """A request's tokens depend on its own seed and n, not on the batch it
    decodes in (other request, larger n_per padding)."""
    p1, p2 = [256] + list(b"first"), [256] + list(b"the second prompt")
    kw = dict(max_new_tokens=8, temperature=1.0, top_k=50)
    solo = engine.generate_many([GenRequestSpec(p1, 2, 5)], **kw)[0]
    both = engine.generate_many([GenRequestSpec(p1, 2, 5), GenRequestSpec(p2, 3, 6)], **kw)
    np.testing.assert_array_equal(both[0].tokens, solo.tokens)
