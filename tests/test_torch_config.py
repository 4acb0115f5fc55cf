"""The PyTorch port's model registry equals the JAX package's, field by field."""

import dataclasses

import pytest
import torch

from k_llms_tpu.models import config as jax_config
from k_llms_tpu_torch.models import config as torch_config

NAMES = sorted(jax_config._REGISTRY)


def test_same_registered_names():
    assert sorted(torch_config._REGISTRY) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_equal(name):
    ref = dataclasses.asdict(jax_config.get_config(name))
    port = dataclasses.asdict(torch_config.get_config(name))
    assert port == ref
    cfg = torch_config.get_config(name)
    assert cfg.torch_dtype == getattr(torch, cfg.dtype)
    assert cfg.q_dim == jax_config.get_config(name).q_dim
    assert cfg.kv_dim == jax_config.get_config(name).kv_dim
