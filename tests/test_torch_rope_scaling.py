"""Llama-3.1/3.2-style RoPE scaling (HF ``rope_type="llama3"``), port against
JAX (twin of ``tests/test_rope_scaling.py``): the scaled inverse
frequencies, the HF parsing and the registered scaled config equal the JAX
package's, and a tiny fp32 model with scaling gives the JAX forward's
logits within 1e-5 at positions past the original context (where the
scaling changes the frequencies)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import shared_params
from k_llms_tpu.models import get_config as jax_get_config
from k_llms_tpu.models import llama as jax_llama
from k_llms_tpu.models.loader import _rope_scaling_from_hf as jax_parse
from k_llms_tpu_torch.models import llama
from k_llms_tpu_torch.models.config import get_config
from k_llms_tpu_torch.models.loader import _rope_scaling_from_hf

SCALING = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
           "high_freq_factor": 4.0, "original_max_position_embeddings": 64}


@pytest.mark.parametrize("d,theta", [(16, 10000.0), (128, 500000.0)])
def test_inv_freq_and_rope_embed_equal_jax(d, theta):
    scaling = _rope_scaling_from_hf(SCALING)
    got = llama._rope_inv_freq(d, theta, scaling, "cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jax_llama._rope_inv_freq(d, theta, scaling)),
                               rtol=1e-6, atol=1e-8)
    x = np.random.default_rng(d).standard_normal((2, 96, 4, d)).astype(np.float32)
    pos = np.tile(np.arange(96, dtype=np.int32), (2, 1)) + np.array([[0], [32]], np.int32)
    want = jax_llama.rope_embed(jnp.asarray(x), jnp.asarray(pos), theta, scaling)
    out = llama.rope_embed(torch.from_numpy(x), torch.from_numpy(pos), theta, scaling)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # Positions past 256: an f32 angle of up to ~300 rad is itself rounded
    # to 2**-15, which the two packages' sin/cos may resolve differently.
    far = pos + 200
    want = jax_llama.rope_embed(jnp.asarray(x), jnp.asarray(far), theta, scaling)
    out = llama.rope_embed(torch.from_numpy(x), torch.from_numpy(far), theta, scaling)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2 ** -15 * np.abs(x).max(),
                               rtol=0)


@pytest.mark.parametrize("rs", [None, {"rope_type": "default"}, SCALING,
                                {"rope_type": "yarn", "factor": 4.0}])
def test_hf_rope_scaling_parsing_equals_jax(rs):
    try:
        want = jax_parse(rs)
    except ValueError:
        with pytest.raises(ValueError):
            _rope_scaling_from_hf(rs)
        return
    assert _rope_scaling_from_hf(rs) == want


def test_registered_scaled_config_equals_jax():
    assert get_config("llama-3.2-1b").rope_scaling == jax_get_config("llama-3.2-1b").rope_scaling \
        == (32.0, 1.0, 4.0, 8192)
    assert get_config("llama-3-8b").rope_scaling is None


def test_logits_with_scaling_match_jax_past_the_original_window():
    over = dict(name="tiny-rope-scaled", rope_scaling=_rope_scaling_from_hf(SCALING))
    jcfg = jax_get_config("tiny").with_(**over)
    cfg = get_config("tiny").with_(**over)
    jparams = shared_params(jcfg, 0)
    params = llama.params_from_numpy(jax.device_get(jparams), cfg)
    tokens = np.random.default_rng(5).integers(0, 256, size=(1, 96)).astype(np.int32)
    mask = np.ones_like(tokens)
    want, _ = jax_llama.forward(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(mask))
    got, _ = llama.forward(cfg, params, torch.from_numpy(tokens), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    unscaled, _ = llama.forward(cfg.with_(rope_scaling=None), params, torch.from_numpy(tokens),
                                torch.from_numpy(mask))
    assert not np.allclose(unscaled.numpy()[0, 64:], got.numpy()[0, 64:], atol=1e-5)
