"""The port's Mixtral variant (top-k token-choice experts, computed densely
over every expert) against the JAX package (twins of ``tests/test_moe.py``
without its mesh case, which waits for the port's mesh): the router's top-k
with JAX's tie rule, every model entry point and the engine on a tiny fp32
config (``tests/_torch_families.py``: logits and KV within 1e-5, greedy
tokens exactly), and the quantized tree (experts int8 under int4, as in
JAX) at the int4 twins' limits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fams
from conftest import shared_engine
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.models import get_config as jax_get_config
from k_llms_tpu.models import llama as jax_llama
from k_llms_tpu.models import quant as jax_quant
from k_llms_tpu_torch.engine.engine import GenRequestSpec, LocalEngine
from k_llms_tpu_torch.models import llama, quant
from k_llms_tpu_torch.models.config import get_config

MOE = dict(name="tiny-moe", num_experts=4, num_experts_per_tok=2)
# int4-eligible attention widths (tests/test_torch_dense_decode.py)
ELIGIBLE = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
                head_dim=64, vocab_size=384, max_seq_len=128)


@pytest.fixture(scope="module")
def fam():
    return fams.Family(MOE)


def test_registry_mixtral_is_served():
    cfg = get_config("mixtral-8x7b")
    assert cfg.num_experts == 8 and cfg.num_experts_per_tok == 2
    llama.check_supported(cfg)


def test_param_tree_equals_jax(fam):
    port = llama.init_params(fam.cfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree_util.tree_map(np.shape, fam.jparams)
    assert {k: tuple(v.shape) for k, v in port["layers"].items()} == want["layers"]
    assert tuple(port["layers"]["w_gate"].shape) == (2, 4, 64, 160)


def test_top_k_takes_the_lower_index_on_a_tie():
    """lax.top_k's order: descending values, a tie to the lower index. The
    MoE output over tied router logits equals the JAX function's."""
    x = np.array([[[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = llama._top_k(torch.tensor(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    cfg, jcfg = get_config("tiny").with_(**MOE), jax_get_config("tiny").with_(**MOE)
    rng = np.random.default_rng(0)
    H, E, I = cfg.hidden_size, cfg.num_experts, cfg.intermediate_size
    # A router whose columns 1, 2 and 3 are equal: every token ties three ways.
    router = rng.normal(size=(H, E)).astype(np.float32)
    router[:, 2] = router[:, 3] = router[:, 1] = np.abs(router[:, 1]) + 1.0
    layer = {"w_router": router,
             "w_gate": rng.normal(size=(E, H, I)).astype(np.float32) / 8,
             "w_up": rng.normal(size=(E, H, I)).astype(np.float32) / 8,
             "w_down": rng.normal(size=(E, I, H)).astype(np.float32) / 13}
    h = np.abs(rng.normal(size=(1, 5, H))).astype(np.float32)
    want = jax_llama._moe_mlp(jcfg, {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(h))
    got = llama._moe_mlp(cfg, {k: torch.tensor(v) for k, v in layer.items()}, torch.tensor(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # Experts 1 and 2 share the weight; expert 3's output is not in it.
    only_12 = dict(layer, w_down=layer["w_down"].copy())
    only_12["w_down"][3] = 0.0
    got_12 = llama._moe_mlp(cfg, {k: torch.tensor(v) for k, v in only_12.items()},
                            torch.tensor(h))
    np.testing.assert_allclose(got_12.numpy(), got.numpy(), atol=1e-6, rtol=0)


def test_dominant_router_selects_its_expert(fam):
    layer = {k: v[0] for k, v in fam.params["layers"].items()}
    H, j = fam.cfg.hidden_size, 2
    router = torch.full((H, fam.cfg.num_experts), -1e4)
    router[:, j] = 1e4
    layer["w_router"] = router
    h = torch.randn((1, 3, H), generator=torch.Generator().manual_seed(2)).abs() + 0.1
    out = llama._moe_mlp(fam.cfg, layer, h)
    gate = torch.nn.functional.silu(h @ layer["w_gate"][j])
    expected = (gate * (h @ layer["w_up"][j])) @ layer["w_down"][j]
    np.testing.assert_allclose(out.numpy(), expected.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_matches_jax(fam, impl):
    fams.check_forward(fam, impl)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_dense_decode_match_jax(fam, impl):
    fams.check_prefill_and_dense_decode(fam, impl)


@pytest.mark.parametrize("impl,attn_impl", [("xla", "xla"), ("flash", "cuda")])
def test_paged_decode_matches_jax(fam, impl, attn_impl):
    """Mixtral has no softcap and no window: the kernel route runs the
    paged kernel's plain version here, K1 on a card."""
    fams.check_paged_decode(fam, impl, attn_impl)


def test_verify_step_matches_jax(fam):
    fams.check_verify_step(fam, "xla")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_continue_matches_jax(fam, impl):
    fams.check_continue(fam, impl)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_chunk_steps_match_jax(fam, impl):
    fams.check_chunks(fam, impl)


@pytest.mark.parametrize("layout,temperature,impl,kernel", [
    ("paged", 0.0, "flash", "cuda"), ("paged", 0.7, "xla", "auto"), ("dense", 0.0, "flash", "auto")])
def test_generate_many_matches_jax_engine(fam, layout, temperature, impl, kernel):
    teng, _ = fams.check_generate_many(fam, layout, temperature, impl,
                                       paged_attention_impl=kernel)
    assert teng.paged_attention_impl == ("cuda" if kernel == "cuda" else "xla")


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_continuous_loop_matches_jax_loop(fam, layout):
    fams.check_loop(fam, layout)


def _kinds(params):
    """Each leaf's kind: "QTensor", "Q4Tensor" or "plain"."""
    def kind(v):
        name = type(v).__name__
        return name if name in ("QTensor", "Q4Tensor") else "plain"
    return {k: kind(v) for k, v in params["layers"].items()} | {"lm_head": kind(params["lm_head"])}


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_tree_keeps_experts_int8(bits):
    """quantize_params and init_params_quantized build JAX's tree: int4
    where eligible (attention, the head), the 4-D expert stacks int8, the
    router plain; quantized bytes and scales equal JAX's."""
    jcfg = jax_get_config("tiny").with_(**MOE, **ELIGIBLE)
    cfg = get_config("tiny").with_(**MOE, **ELIGIBLE)
    jp = jax_llama.init_params(jcfg, jax.random.key(0))
    ref = jax_quant.quantize_params(jp, bits=bits)
    got = quant.quantize_params(llama.params_from_numpy(jax.device_get(jp), cfg), bits=bits)
    assert _kinds(got) == _kinds(ref)
    assert _kinds(got)["w_gate"] == "QTensor" and _kinds(got)["w_router"] == "plain"
    assert _kinds(got)["wq"] == ("Q4Tensor" if bits == 4 else "QTensor")
    for key in ("w_gate", "w_down", "wo"):
        np.testing.assert_array_equal(got["layers"][key].q.numpy(), np.asarray(ref["layers"][key].q))
        np.testing.assert_array_equal(got["layers"][key].scale.numpy(),
                                      np.asarray(ref["layers"][key].scale))
    init_ref = jax.device_get(jax_quant.init_params_quantized(jcfg, jax.random.key(0), bits=bits))
    init_got = quant.init_params_quantized(cfg, torch.Generator().manual_seed(0), "cpu", bits=bits)
    assert _kinds(init_got) == _kinds(init_ref)
    for key, r in init_ref["layers"].items():
        g = init_got["layers"][key]
        if hasattr(r, "q"):
            assert tuple(g.q.shape) == r.q.shape
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(r.scale))
        else:
            assert tuple(g.shape) == r.shape


@pytest.fixture(scope="module")
def int4_weights():
    jcfg = jax_get_config("tiny").with_(**MOE, **ELIGIBLE)
    jeng = shared_engine(jcfg, quantize="int4")
    cfg = get_config("tiny").with_(**MOE, **ELIGIBLE)
    return jeng, cfg, llama.params_from_numpy(jax.device_get(jeng.params), cfg)


def test_int4_mixtral_forward_and_generate_match_jax(int4_weights):
    """The quantized Mixtral (int4 attention and head through the w4a16
    kernel's plain version, int8 experts through qeinsum): forward logits
    within the int4 twins' 1e-4, greedy tokens of the paged engine equal
    to the JAX engine's, logprobs within 1e-4."""
    jeng, cfg, params = int4_weights
    assert type(params["layers"]["wq"]).__name__ == "Q4Tensor"
    assert type(params["layers"]["w_up"]).__name__ == "QTensor"
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 300, size=(2, 24)).astype(np.int32)
    mask = np.ones_like(tokens)
    mask[1, 17:] = 0
    ref, _ = jax_llama.forward(jeng.config, jeng.params, jnp.asarray(tokens), jnp.asarray(mask))
    got, _ = llama.forward(cfg, params, torch.from_numpy(tokens), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)

    teng = LocalEngine(cfg, params=params, device="cpu", kv_page_size=16,
                       paged_attention_impl="cuda")
    assert teng.quantized == "int4"
    kw = dict(max_new_tokens=8, temperature=0.0)
    want = jeng.generate_many([JaxSpec(fams.PROMPTS[0], 3, 1)], **kw)
    out = teng.generate_many([GenRequestSpec(fams.PROMPTS[0], 3, 1)], **kw)
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4, rtol=0)


def test_client_int4_mixtral_keeps_experts_int8(monkeypatch):
    """``quantization="int4"`` on a Mixtral config through the user's entry
    point: attention and head int4, expert stacks int8, the router plain."""
    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.models import config as torch_config

    # Registered for this test only: the registry must stay equal to the JAX one.
    monkeypatch.setitem(torch_config._REGISTRY, "tiny-moe-int4-client",
                        get_config("tiny").with_(**dict(MOE, name="tiny-moe-int4-client"), **ELIGIBLE))
    client = KLLMs(backend="cuda", model="tiny-moe-int4-client", device="cpu",
                   quantization="int4")
    try:
        engine = client.backend.engine
        layers = engine.params["layers"]
        assert engine.quantized == "int4"
        assert type(layers["wq"]).__name__ == "Q4Tensor"
        assert type(engine.params["lm_head"]).__name__ == "Q4Tensor"
        assert type(layers["w_gate"]).__name__ == "QTensor" and layers["w_gate"].q.dim() == 4
        assert isinstance(layers["w_router"], torch.Tensor)
        r = client.chat.completions.create(messages=[{"role": "user", "content": "hi"}], n=2,
                                           seed=3, max_tokens=6)
        assert len(r.choices) == 3
    finally:
        client.close()
