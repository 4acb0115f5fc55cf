"""Llama-family model in PyTorch: configs, parameters, prefill and the paged
decode step."""

from .config import ModelConfig, get_config, register_config
from .llama import forward, init_params, params_from_numpy, prefill

__all__ = [
    "ModelConfig",
    "get_config",
    "register_config",
    "init_params",
    "params_from_numpy",
    "forward",
    "prefill",
]
