"""The port's train step (``k_llms_tpu_torch/engine/training.py``) against
the JAX package's ``k_llms_tpu.engine.training``, unsharded, on fp32 tiny
weights from the parity harness and tokens and pad masks from a numpy seed
(rows padded to different lengths).

Limits: the loss relative 1e-6; each leaf's gradient against ``jax.grad``
of JAX's ``causal_lm_loss`` within ``1e-5 * max|g_jax|``; the default
optimizer against ``optax.adamw(1e-4)`` on the same gradients within 1e-6
absolute over five steps; three ``make_train_step`` steps: losses relative
1e-5 and parameters 5e-5 absolute. The last is Adam's: its first steps move
an element with a near-zero gradient by up to the learning rate whatever
sign that gradient's float noise has, and JAX's own sharded and unsharded
steps differ by up to 3.1e-5 at lr 1e-4 (tiny fp32, a [4, 32] batch with one
padded row, one step)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import shared_params
from k_llms_tpu.engine import training as jax_training
from k_llms_tpu.engine.engine import LocalEngine as JaxEngine
from k_llms_tpu.models import config as jax_config
from k_llms_tpu.models import get_config as jax_get_config
from k_llms_tpu.models import quant as jax_quant
from k_llms_tpu_torch.engine import training
from k_llms_tpu_torch.engine.engine import LocalEngine
from k_llms_tpu_torch.models import config as torch_config
from k_llms_tpu_torch.models import llama
from k_llms_tpu_torch.models.config import get_config
from test_torch_gemma import GEMMA
from test_torch_moe import MOE

FAMILIES = {"tiny": {}, "tiny-gemma": GEMMA, "tiny-moe": MOE}
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
ADAM_ATOL = 1e-6
STEP_LOSS_RTOL = 1e-5
STEP_PARAM_ATOL = 5e-5


@pytest.fixture(params=sorted(FAMILIES))
def family(request, monkeypatch):
    """(JAX config, port config, JAX params) of a tiny fp32 family,
    registered in both registries."""
    overrides = dict(FAMILIES[request.param], name=request.param)
    jcfg = jax_get_config("tiny").with_(**overrides)
    cfg = get_config("tiny").with_(**overrides)
    monkeypatch.setitem(jax_config._REGISTRY, request.param, jcfg)
    monkeypatch.setitem(torch_config._REGISTRY, request.param, cfg)
    return jcfg, cfg, shared_params(jcfg)


def batch(B=4, S=32, vocab=512, seed=0):
    """Seeded tokens and a pad mask whose rows end at different lengths
    (right padding, one row whole)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = np.ones_like(tokens)
    for row, length in enumerate([S, 20, 27, 9][:B]):
        mask[row, length:] = 0
    tokens[mask == 0] = 2  # the pad id
    return tokens, mask


def leaf_pairs(jax_tree, port_tree):
    """(path, JAX leaf as numpy, port leaf) in the port's leaf order."""
    jax_tree = jax.device_get(jax_tree)
    out = []
    for path, leaf in training._leaves(port_tree):
        node = jax_tree
        for part in path.split("."):
            node = node[part]
        out.append((path, np.asarray(node), leaf))
    return out


def test_loss_and_gradients_equal_jax(family):
    jcfg, cfg, jparams = family
    tokens, mask = batch()
    want, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_training.causal_lm_loss(jcfg, p, jnp.asarray(tokens), jnp.asarray(mask))
    ))(jparams)
    tree = llama.params_from_numpy(jax.device_get(jparams), cfg)
    leaves = [leaf for _, leaf in training._leaves(tree)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    got = training.causal_lm_loss(cfg, tree, torch.from_numpy(tokens), torch.from_numpy(mask))
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    for path, g_jax, leaf in leaf_pairs(grads, tree):
        err = np.abs(leaf.grad.numpy() - g_jax).max()
        assert err <= GRAD_RTOL * np.abs(g_jax).max(), (path, err, np.abs(g_jax).max())


def test_default_optimizer_equals_optax_adamw():
    """Five steps of ``training.adamw`` and ``optax.adamw(1e-4)`` fed the
    same gradients (magnitudes spread over e^-25..1) on O(1) fp32
    parameters."""
    rng = np.random.default_rng(0)
    shapes = [(64, 48), (48,), (3, 16, 40)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * np.exp(rng.uniform(-25, 0, size=s))).astype(np.float32)
              for s in shapes] for _ in range(5)]
    opt = optax.adamw(1e-4)
    update, apply_updates = jax.jit(opt.update), jax.jit(optax.apply_updates)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.tensor(p) for p in params]
    topt = training.adamw(tp)
    for step in grads:
        updates, state = update([jnp.asarray(g) for g in step], state, jp)
        jp = apply_updates(jp, updates)
        for t, g in zip(tp, step):
            t.grad = torch.tensor(g)
        topt.step()
    for t, j in zip(tp, jp):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ADAM_ATOL)
    moments = topt.state[tp[0]]
    assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == torch.float32


def test_three_steps_equal_jax_make_train_step():
    jcfg, cfg = jax_get_config("tiny"), get_config("tiny")
    jparams = shared_params(jcfg)
    tokens, mask = batch()
    init_j, step_j = jax_training.make_train_step(jcfg)
    state = init_j(jparams)
    tree = llama.params_from_numpy(jax.device_get(jparams), cfg)
    init_p, step_p = training.make_train_step(cfg)
    opt = init_p(tree)
    for _ in range(3):
        jparams, state, want = step_j(jparams, state, jnp.asarray(tokens), jnp.asarray(mask))
        out, opt, got = step_p(tree, opt, tokens, mask)
        assert out is tree and got.dtype == torch.float32 and got.dim() == 0
        assert abs(got.item() - float(want)) <= STEP_LOSS_RTOL * abs(float(want))
    for path, p_jax, leaf in leaf_pairs(jparams, tree):
        assert not leaf.requires_grad and leaf.grad is None
        err = np.abs(leaf.numpy() - p_jax).max()
        assert err <= STEP_PARAM_ATOL, (path, err)


def test_refuses_flash_and_quantized_as_jax_fails():
    """A flash config and an int8 tree: the port raises its typed error
    naming the field before any work, and JAX's step fails on the same
    inputs."""
    tokens, mask = batch(B=2, S=16)
    jtiny = jax_get_config("tiny")
    jparams = shared_params(jtiny)

    flash = get_config("tiny").with_(attention_impl="flash")
    with pytest.raises(training.UntrainableError, match="attention_impl"):
        training.make_train_step(flash)
    init_j, step_j = jax_training.make_train_step(jtiny.with_(attention_impl="flash"))
    with pytest.raises(Exception):
        step_j(jparams, init_j(jparams), jnp.asarray(tokens), jnp.asarray(mask))

    jq = jax_quant.quantize_params(jparams, bits=8)
    tree = llama.params_from_numpy(jax.device_get(jq), get_config("tiny"))
    init_p, step_p = training.make_train_step(get_config("tiny"))
    with pytest.raises(training.UntrainableError, match=r"layers\.wq is quantized \(int8\)"):
        init_p(tree)
    with pytest.raises(training.UntrainableError, match="quantized"):
        step_p(tree, None, tokens, mask)
    init_j, step_j = jax_training.make_train_step(jtiny)
    with pytest.raises(Exception):
        step_j(jq, init_j(jq), jnp.asarray(tokens), jnp.asarray(mask))


def test_step_refuses_a_state_of_another_tree():
    cfg = get_config("tiny")
    jparams = shared_params(jax_get_config("tiny"))
    tree = llama.params_from_numpy(jax.device_get(jparams), cfg)
    other = llama.params_from_numpy(jax.device_get(jparams), cfg)
    init_p, step_p = training.make_train_step(cfg)
    tokens, mask = batch(B=2, S=16)
    with pytest.raises(ValueError, match="init_state"):
        step_p(tree, init_p(other), tokens, mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_to_numpy_inverts_params_from_numpy(dtype):
    cfg = get_config("tiny").with_(dtype=dtype)
    tree = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    back = llama.params_from_numpy(llama.params_to_numpy(tree), cfg)
    for (path, leaf), (_, again) in zip(training._leaves(tree), training._leaves(back)):
        assert again.dtype == leaf.dtype and torch.equal(again, leaf), path


def test_trained_tree_serves_in_the_jax_engine():
    """Two port steps, then the trained tree through ``params_to_numpy``
    into JAX's engine: the same greedy tokens as the port's engine on the
    tree itself."""
    jcfg, cfg = jax_get_config("tiny"), get_config("tiny")
    tree = llama.params_from_numpy(jax.device_get(shared_params(jcfg)), cfg)
    init_p, step_p = training.make_train_step(cfg)
    opt = init_p(tree)
    tokens, mask = batch()
    for _ in range(2):
        tree, opt, _ = step_p(tree, opt, tokens, mask)
    prompt = list(range(5, 45))
    kw = dict(n=2, max_new_tokens=8, temperature=0.0, seed=0)
    got = LocalEngine(cfg, params=tree, device="cpu").generate(prompt, **kw)
    want = JaxEngine(jcfg, params=llama.params_to_numpy(tree), use_mesh=False).generate(prompt, **kw)
    np.testing.assert_array_equal(np.asarray(got.tokens), np.asarray(want.tokens))
