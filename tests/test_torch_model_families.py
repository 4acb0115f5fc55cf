"""The port's Mistral variant (a sliding window on every layer) against the
JAX package (twins of the Mistral and window cases of
``tests/test_model_families.py``), on a tiny fp32 config whose window (8) is
shorter than its prompts. Weights come from the JAX ``init_params``; logits
and KV within 1e-5, greedy tokens exactly (``tests/_torch_families.py``)."""

import numpy as np
import pytest
import torch

import _torch_families as fams
from k_llms_tpu_torch.engine.engine import LocalEngine
from k_llms_tpu_torch.models import llama
from k_llms_tpu_torch.models.config import get_config
from k_llms_tpu_torch.ops import paged_attention as pa
from k_llms_tpu_torch.utils.observability import KERNEL_EVENTS

MISTRAL = dict(name="tiny-mistral", sliding_window=8)


@pytest.fixture(scope="module")
def fam():
    return fams.Family(MISTRAL)


def test_registry_mistral_is_served():
    cfg = get_config("mistral-7b")
    assert cfg.sliding_window == 4096 and cfg.sliding_window_layers == "all"
    llama.check_supported(cfg)


def test_window_covering_the_sequence_equals_causal(fam):
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (1, 10)))
    mask = torch.ones_like(tokens)
    wide, _ = llama.forward(fam.cfg.with_(sliding_window=64), fam.params, tokens, mask)
    causal, _ = llama.forward(fam.cfg.with_(sliding_window=None), fam.params, tokens, mask)
    np.testing.assert_allclose(wide.numpy(), causal.numpy(), atol=1e-5, rtol=0)


def test_window_restricts_attention(fam):
    """Positions inside the window agree with the causal model; late ones
    do not."""
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 512, (1, 16)))
    mask = torch.ones_like(tokens)
    win, _ = llama.forward(fam.cfg, fam.params, tokens, mask)
    causal, _ = llama.forward(fam.cfg.with_(sliding_window=None), fam.params, tokens, mask)
    np.testing.assert_allclose(win[0, 1].numpy(), causal[0, 1].numpy(), atol=1e-5, rtol=0)
    assert not np.allclose(win[0, -1].numpy(), causal[0, -1].numpy())


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_matches_jax(fam, impl):
    fams.check_forward(fam, impl)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_dense_decode_match_jax(fam, impl):
    fams.check_prefill_and_dense_decode(fam, impl)


@pytest.mark.parametrize("impl,attn_impl", [("xla", "xla"), ("flash", "cuda")])
def test_paged_decode_matches_jax(fam, impl, attn_impl):
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
    ("paged", 0.0, "flash"), ("paged", 0.7, "xla"), ("dense", 0.7, "flash")])
def test_generate_many_matches_jax_engine(fam, layout, temperature, impl):
    fams.check_generate_many(fam, layout, temperature, impl)


def test_resolve_counts_an_explicit_kernel_request(fam):
    """The JAX routing: a windowed config resolves to the reference; an
    explicit "cuda" or "pallas" request is counted as a sliding_window
    fallback, "auto" (on a card too) is not."""
    before = KERNEL_EVENTS.get("kernel.paged_attn_fallback.sliding_window")
    for requested in ("auto", "cuda", "pallas", "xla"):
        for device in ("cpu", "cuda"):
            assert pa.resolve_paged_attention_impl(requested, device=device, config=fam.cfg) == "xla"
    assert KERNEL_EVENTS.get("kernel.paged_attn_fallback.sliding_window") == before + 4
    assert pa.resolve_paged_attention_impl("auto", device="cuda", config=get_config("tiny")) == "cuda"
    eng = LocalEngine(fam.cfg, params=fam.params, device="cpu")
    assert eng.paged_attention_impl == "xla"


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_continuous_loop_matches_jax_loop(fam, layout):
    fams.check_loop(fam, layout)
