"""The port's sharded train step against JAX's ``make_train_step`` on a mesh
of the same shape: a gloo world of four spawned port ranks
(``_torch_mesh_worker``; a mesh smaller than the world runs as identical
replicas) beside the JAX mesh over the forced CPU devices. Tiny fp32
weights from the parity harness; every rank passes the same global batch,
whose data shards have different pad masks.

Limits are the unsharded twins' (``test_torch_training.py``): every rank's
loss relative 1e-5 of JAX's, every rank's updated shard within 5e-5 of the
matching slice of JAX's updated parameters. The collective counts of a step
hold their formula: the model axis sums the two row-parallel outputs a
layer and the embedding forward, and the three inputs of rank-specific work
(attention, MLP, head; Mixtral adds the router's combine weight) backward,
and gathers the logits once; the data axis sums the valid count, the
gradients (one flat buffer) and the loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh import jax_mesh, port_config, port_tree, world_fixture
from conftest import shared_params
from k_llms_tpu.engine import training as jax_training
from k_llms_tpu.models import get_config
from k_llms_tpu_torch.engine import training
from k_llms_tpu_torch.parallel.sharding import param_specs
from test_torch_moe import MOE
from test_torch_training import STEP_LOSS_RTOL, STEP_PARAM_ATOL, batch

world = world_fixture(4)

TINY = get_config("tiny")
STEPS = 3


def jax_steps(cfg, params, shape, tokens, mask, steps=STEPS):
    init_state, step = jax_training.make_train_step(cfg, mesh=jax_mesh(*shape))
    state = init_state(params)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, jnp.asarray(tokens), jnp.asarray(mask))
        losses.append(float(loss))
    return losses, jax.device_get(params)


def shard_of(full, spec, model_index, model_size):
    """The block of a full leaf a model rank holds under ``spec``."""
    index = []
    for dim, axis in enumerate(spec):
        if axis == "model" and model_size > 1:
            block = full.shape[dim] // model_size
            index.append(slice(model_index * block, (model_index + 1) * block))
        else:
            index.append(slice(None))
    return full[tuple(index)]


def expected_counts(cfg, shape):
    D, M = shape
    L = cfg.num_layers
    backward = (3 if cfg.num_experts else 2) * L + 1
    return {"psum": (2 * L + 1 + backward if M > 1 else 0) + (3 if D > 1 else 0),
            "pmax": 0, "all_gather": int(M > 1), "ppermute": 0, "all_to_all": 0, "gather": 0,
            "host_staged_bytes": 0}


def check(world, cfg, shape, tokens, mask):
    params = shared_params(cfg)
    want_losses, want = jax_steps(cfg, params, shape, tokens, mask)
    res = world.run("train_step", shape=shape, config=port_config(cfg),
                    params=port_tree(params, cfg), tokens=tokens, mask=mask, steps=STEPS)
    specs = param_specs(cfg)
    L = cfg.num_layers
    for r in res:
        for got, ref in zip(r["losses"], want_losses):
            assert abs(got - ref) <= STEP_LOSS_RTOL * abs(ref), (r["coords"], got, ref)
        assert r["counts"] == [expected_counts(cfg, shape)] * STEPS
        M = shape[1]
        assert r["forward_counts"]["psum"] == (2 * L + 1 if M > 1 else 0)
        assert r["forward_counts"]["all_gather"] == int(M > 1)
        _, model_index = r["coords"]
        for path, got in r["params"].items():
            spec, full = specs, want
            for part in path.split("."):
                spec, full = spec[part], full[part]
            ref = shard_of(np.asarray(full), spec, model_index, M)
            assert got.shape == ref.shape, path
            err = np.abs(got - ref).max()
            assert err <= STEP_PARAM_ATOL, (r["coords"], path, err)
    return res


def test_data_shards_have_different_pad_masks():
    """The batch the mesh twins use: a mean of the two data shards' mean
    losses misses the global loss by more than ten times the twins' limit."""
    tokens, mask = batch()
    tree = port_tree(shared_params(TINY), TINY)

    def loss(rows):  # the port's loss, equal to JAX's (test_torch_training.py)
        return training.causal_lm_loss(port_config(TINY), tree, torch.from_numpy(tokens[rows]),
                                       torch.from_numpy(mask[rows])).item()

    whole = loss(slice(0, 4))
    per_shard = (loss(slice(0, 2)) + loss(slice(2, 4))) / 2
    assert mask[:2, 1:].sum() != mask[2:, 1:].sum()
    assert abs(per_shard - whole) > 10 * STEP_LOSS_RTOL * whole


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
def test_sharded_step_matches_jax_mesh_step(world, shape):
    tokens, mask = batch()
    res = check(world, TINY, shape, tokens, mask)
    # SPMD: the loss is replicated over the whole mesh.
    assert len({tuple(r["losses"]) for r in res}) == 1


def test_moe_router_gradient_across_expert_shards(world):
    """Mixtral's experts split over model = 2 while the router replicates:
    its gradient reaches each rank through that rank's experts only, and
    the step sums it over model."""
    check(world, TINY.with_(**MOE), (1, 2), *batch())


def test_batch_rows_must_divide_over_data(world):
    tokens, mask = batch(B=3)
    res = world.run("train_error", shape=(2, 2), config=port_config(TINY),
                    params=port_tree(shared_params(TINY), TINY), tokens=tokens, mask=mask)
    for kind, message in res:
        assert kind == "ValueError" and "3 rows does not divide over data=2" in message
