"""The real-checkpoint path of the port, the twin of
``tests/test_real_checkpoint.py`` on the same in-process miniature HF
checkpoint (a trained byte-level BPE tokenizer and a random 2-layer Llama
written by ``save_pretrained``): ``config_from_hf`` → the port's
``load_safetensors`` → ``HFTokenizer`` → generate. The logits equal
``transformers``' ``LlamaForCausalLM`` and the JAX forward, and
``KLLMs(backend="cuda", model=<dir>, checkpoint_path=<dir>,
tokenizer_path=<dir>, device="cpu")`` gives the JAX client's samples for
``create()`` and for ``parse()`` under the BPE grammar."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from pydantic import BaseModel

from test_real_checkpoint import hf_dir  # noqa: F401  (the module-scoped fixture)

from k_llms_tpu import KLLMs as JaxKLLMs
from k_llms_tpu.models.llama import forward as jax_forward
from k_llms_tpu.models.loader import config_from_hf as jax_config_from_hf
from k_llms_tpu.models.loader import load_safetensors as jax_load_safetensors
from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.engine.tokenizer import HFTokenizer
from k_llms_tpu_torch.models.llama import forward
from k_llms_tpu_torch.models.loader import config_from_hf, load_safetensors


class Item(BaseModel):
    name: str
    count: int


def _ids(hf_dir):
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(hf_dir, local_files_only=True)
    return [tok.bos_token_id] + tok.encode(
        "The quick brown fox jumps over the lazy invoice.", add_special_tokens=False
    )


def test_logits_match_transformers_and_jax(hf_dir):  # noqa: F811
    from transformers import LlamaForCausalLM

    cfg = config_from_hf(hf_dir).with_(dtype="float32")
    params = load_safetensors(hf_dir, cfg)
    ids = _ids(hf_dir)
    tokens = torch.tensor([ids])
    ours, _ = forward(cfg, params, tokens, torch.ones_like(tokens))

    model = LlamaForCausalLM.from_pretrained(hf_dir, torch_dtype=torch.float32).eval()
    with torch.no_grad():
        theirs = model(tokens).logits.numpy()
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=2e-4, atol=2e-4)

    jcfg = jax_config_from_hf(hf_dir).with_(dtype="float32")
    jparams = jax_load_safetensors(hf_dir, jcfg, dtype=jnp.float32)
    jtok = jnp.asarray([ids], jnp.int32)
    ref, _ = jax_forward(jcfg, jparams, jtok, jnp.ones_like(jtok))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def clients(hf_dir):  # noqa: F811
    kw = dict(model=hf_dir, checkpoint_path=hf_dir, tokenizer_path=hf_dir, dtype="float32",
              max_new_tokens=12)
    jax_client = JaxKLLMs(backend="tpu", **kw)
    port = KLLMs(backend="cuda", device="cpu", **kw)
    yield jax_client, port
    jax_client.close()


def test_client_loads_the_checkpoint(clients, hf_dir):  # noqa: F811
    jax_client, port = clients
    backend = port.backend
    assert isinstance(backend.tokenizer, HFTokenizer)
    assert backend.engine.config.name == jax_client.backend.engine.config.name
    assert backend.engine.config.vocab_size == jax_client.backend.engine.config.vocab_size
    assert backend.param_summary == jax_client.backend.param_summary
    assert backend.param_summary["dtype_histogram"] == {"float32": 12}


@pytest.mark.parametrize("temperature,seed", [(0.0, 1), (0.9, 11)])
def test_create_equals_the_jax_client(clients, hf_dir, temperature, seed):  # noqa: F811
    jax_client, port = clients
    kw = dict(messages=[{"role": "user", "content": "Say something."}], model=hf_dir, n=3,
              temperature=temperature, seed=seed)
    ref = jax_client.chat.completions.create(**kw)
    out = port.chat.completions.create(**kw)
    assert [c.message.content for c in out.choices] == [c.message.content for c in ref.choices]
    assert [c.finish_reason for c in out.choices] == [c.finish_reason for c in ref.choices]
    assert out.usage.model_dump() == ref.usage.model_dump()
    np.testing.assert_allclose([c.sample_logprob for c in out.choices[1:]],
                               [c.sample_logprob for c in ref.choices[1:]], atol=1e-4, rtol=0)


def test_parse_under_the_bpe_grammar_equals_the_jax_client(clients, hf_dir):  # noqa: F811
    jax_client, port = clients
    kw = dict(messages=[{"role": "user", "content": "Extract the item."}], response_format=Item,
              model=hf_dir, n=2, temperature=0.9, seed=3, max_tokens=48)
    ref = jax_client.chat.completions.parse(**kw)
    out = port.chat.completions.parse(**kw)
    assert [c.message.content for c in out.choices] == [c.message.content for c in ref.choices]
    assert len(out.choices) == 3
    for c in out.choices[1:]:
        if c.finish_reason == "stop":  # completed samples must validate
            Item.model_validate(json.loads(c.message.content))
