"""Helpers of the port's mesh twins (JAX side): the JAX mesh of a shape over
the 8 CPU devices ``tests/conftest.py`` forces, the port's config and
parameter tree of a JAX one, and a module-scoped gloo world of spawned port
ranks (``_torch_mesh_worker.World``)."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from _torch_mesh_worker import World


def jax_mesh(data, model):
    from k_llms_tpu.parallel.mesh import make_mesh

    return make_mesh(data, model, jax.devices()[: data * model])


def port_config(cfg):
    """The port's ModelConfig with every field of the JAX one."""
    from k_llms_tpu_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{n: getattr(cfg, n) for n in names})


def port_tree(params, cfg):
    """A JAX parameter tree as the port's tree (numpy leaves through
    ``params_from_numpy``, quantized leaves included)."""
    from k_llms_tpu_torch.models.llama import params_from_numpy

    return params_from_numpy(jax.device_get(params), port_config(cfg))


def world_fixture(size, env=None):
    """A module-scoped fixture: one world of ``size`` ranks for the file."""

    @pytest.fixture(scope="module")
    def world(tmp_path_factory):
        w = World(size, tmp_path_factory.mktemp(f"world{size}"),
                  env={"KLLMS_RANK_CHECK": "1", **(env or {})})
        yield w
        w.close()

    return world


def assert_same_on_ranks(results):
    """Every rank returned the same tokens (the SPMD contract)."""
    first = results[0]
    for r in results[1:]:
        for a, b in zip(first, r):
            if isinstance(a, dict) and "tokens" in a:
                np.testing.assert_array_equal(a["tokens"], b["tokens"])
                np.testing.assert_array_equal(a["logprobs"], b["logprobs"])
