"""Helpers for the port's serving-layer tests: port backends on the CPU
holding the JAX package's seeded ``tiny`` weights. JAX is imported only by
the helpers that need it."""

from k_llms_tpu_torch.backends.cuda import BackendConfig, CudaBackend
from k_llms_tpu_torch.engine.engine import LocalEngine
from k_llms_tpu_torch.engine.tokenizer import ByteTokenizer
from k_llms_tpu_torch.models import llama
from k_llms_tpu_torch.models.config import get_config

_PORT_PARAMS = {}


def port_params(name="tiny"):
    """The JAX package's ``init_params(config, key(0))`` as port tensors."""
    params = _PORT_PARAMS.get(name)
    if params is None:
        import jax

        from conftest import shared_params
        from k_llms_tpu.models import get_config as jax_get_config

        jax_params = shared_params(jax_get_config(name), 0)
        params = llama.params_from_numpy(jax.device_get(jax_params), get_config(name))
        _PORT_PARAMS[name] = params
    return params


def port_backend(paged=True, **config):
    """A port backend on the CPU whose engine holds the JAX weights."""
    engine = LocalEngine(
        "tiny", params=port_params(), device="cpu",
        kv_layout="paged" if paged else "dense", kv_page_size=8,
    )
    config.setdefault("max_new_tokens", 8)
    return CudaBackend(config=BackendConfig(model="tiny", device="cpu", **config), engine=engine)


def prompt(text):
    return ByteTokenizer().apply_chat_template(
        [{"role": "user", "content": text}], add_generation_prompt=True
    )
