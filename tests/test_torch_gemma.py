"""The port's Gemma-2 variants against the JAX package (twins of
``tests/test_gemma.py``): GeGLU, offset RMSNorm, post-block norms, the
embedding scale, the attention and logit softcaps, and alternating
local/global attention, on a tiny fp32 config whose window (8) is shorter
than its prompts. Weights come from the JAX ``init_params``; logits and KV
within 1e-5, greedy tokens exactly (``tests/_torch_families.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fams
from k_llms_tpu.models import llama as jax_llama
from k_llms_tpu_torch.engine.engine import LocalEngine
from k_llms_tpu_torch.models import llama
from k_llms_tpu_torch.models.config import get_config
from k_llms_tpu_torch.utils.observability import KERNEL_EVENTS

GEMMA = dict(name="tiny-gemma", sliding_window=8, sliding_window_layers="alternating",
             act="gelu", norm_offset=True, embed_scale=True, post_block_norms=True,
             attn_softcap=50.0, logit_softcap=30.0, query_scale=16.0 ** -0.5,
             num_layers=4)  # two local, two global layers


@pytest.fixture(scope="module")
def fam():
    return fams.Family(GEMMA)


def test_registry_gemma_configs_are_served():
    for name in ("gemma-2-2b", "gemma-2-9b"):
        cfg = get_config(name)
        assert cfg.post_block_norms and cfg.attn_softcap == 50.0 and cfg.head_dim == 256
        assert cfg.sliding_window_layers == "alternating"
        llama.check_supported(cfg)


def test_param_tree_equals_jax(fam):
    """init_params draws the JAX tree's leaves: post-block norms, offset
    norms at 0, the same shapes."""
    port = llama.init_params(fam.cfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree_util.tree_map(np.shape, fam.jparams)
    assert {k: tuple(v.shape) for k, v in port["layers"].items()} == want["layers"]
    for key in ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm"):
        assert float(port["layers"][key].abs().max()) == 0.0
    assert float(port["final_norm"].abs().max()) == 0.0


def test_offset_norm_and_embed_scale_round_as_in_jax():
    """In bf16: (1 + w) formed in f32 and cast, sqrt(H) cast before the
    multiply (sqrt(3584) = 59.87 becomes 59.75); bit-equal to the JAX
    functions."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 3584)).astype(np.float32)
    w = (rng.normal(size=(3584,)) * 0.3).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    tx, tw = torch.tensor(x).bfloat16(), torch.tensor(w).bfloat16()
    want = jax_llama.rms_norm(jx, jw, 1e-6, offset=True)
    got = llama.rms_norm(tx, tw, 1e-6, offset=True)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))

    cfg = get_config("gemma-2-9b")
    embed = rng.normal(size=(16, 3584)).astype(np.float32)
    ids = np.array([[1, 5, 15]], np.int32)
    want = jax_llama._embed(cfg, {"embed": jnp.asarray(embed, jnp.bfloat16)}, jnp.asarray(ids))
    got = llama._embed(cfg, {"embed": torch.tensor(embed).bfloat16()}, torch.tensor(ids))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert float(torch.tensor(3584 ** 0.5, dtype=torch.bfloat16)) == 59.75


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_matches_jax(fam, impl):
    logits = fams.check_forward(fam, impl)
    assert float(logits.abs().max()) < 30.0  # the logit softcap


def test_alternating_differs_from_all_windowed(fam):
    """Global layers see past the window: the alternating model is not the
    every-layer-windowed one (each still equals its JAX twin)."""
    alt = fams.check_forward(fam, "xla")
    every = fams.Family(dict(GEMMA, sliding_window_layers="all"))
    assert not torch.allclose(alt, fams.check_forward(every, "xla"), atol=1e-3)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_dense_decode_match_jax(fam, impl):
    fams.check_prefill_and_dense_decode(fam, impl)


@pytest.mark.parametrize("impl,attn_impl", [("xla", "xla"), ("flash", "cuda")])
def test_paged_decode_matches_jax(fam, impl, attn_impl):
    """The paged step; an explicit kernel route takes the reference, as the
    JAX gate does for softcapped and windowed models."""
    fams.check_paged_decode(fam, impl, attn_impl)


def test_verify_step_matches_jax(fam):
    fams.check_verify_step(fam, "xla")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_continue_matches_jax(fam, impl):
    fams.check_continue(fam, impl)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_chunk_steps_match_jax(fam, impl):
    fams.check_chunks(fam, impl)


@pytest.mark.parametrize("layout,temperature,impl", [
    ("paged", 0.0, "xla"), ("paged", 0.7, "flash"), ("dense", 0.0, "flash")])
def test_generate_many_matches_jax_engine(fam, layout, temperature, impl):
    fams.check_generate_many(fam, layout, temperature, impl)


def test_paged_engine_resolves_to_the_reference_route(fam):
    """A softcapped model's paged decode resolves to the reference when the
    engine is built; an explicit kernel request is counted, "auto" is not."""
    before = KERNEL_EVENTS.get("kernel.paged_attn_fallback.softcap")
    eng = LocalEngine(fam.cfg, params=fam.params, device="cpu", paged_attention_impl="cuda")
    assert eng.paged_attention_impl == "xla"
    assert KERNEL_EVENTS.get("kernel.paged_attn_fallback.softcap") == before + 1
    eng = LocalEngine(fam.cfg, params=fam.params, device="cpu", paged_attention_impl="auto")
    assert eng.paged_attention_impl == "xla"
    assert KERNEL_EVENTS.get("kernel.paged_attn_fallback.softcap") == before + 1


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_continuous_loop_matches_jax_loop(fam, layout):
    fams.check_loop(fam, layout)


def test_client_serves_a_gemma_config(fam, monkeypatch):
    """The user's entry point on a registered Gemma-2 config: the flash
    prefill route, the reference paged decode, consensus and likelihoods."""
    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.models import config as torch_config

    # Registered for this test only: the registry must stay equal to the JAX one.
    monkeypatch.setitem(torch_config._REGISTRY, "tiny-gemma-client",
                        fam.cfg.with_(name="tiny-gemma-client"))
    client = KLLMs(backend="cuda", model="tiny-gemma-client", device="cpu", attention_impl="flash")
    try:
        engine = client.backend.engine
        assert engine.config.attention_impl == "flash" and engine.paged_attention_impl == "xla"
        r = client.chat.completions.create(messages=[{"role": "user", "content": "hi"}], n=3,
                                           seed=7, max_tokens=8)
        assert len(r.choices) == 4 and r.likelihoods is not None
        hbm = client.backend.health()["hbm"]
        assert hbm["param_bytes"] == engine.param_footprint_bytes() and hbm["paged"]
    finally:
        client.close()
