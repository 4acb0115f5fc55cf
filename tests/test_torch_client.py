"""End to end through the client: ``KLLMs(backend="cuda", model="tiny",
device="cpu")`` against the JAX package's ``KLLMs(backend="tpu")`` on the same
carried-over weights; the port imports neither JAX nor the JAX package; and
without a card the port raises instead of running on the CPU."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pydantic
import pytest
import torch

from conftest import shared_engine, shared_params
from k_llms_tpu import KLLMs as JaxKLLMs
from k_llms_tpu.backends.tpu import TpuBackend
from k_llms_tpu.models import get_config as jax_get_config
from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.models.llama import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESSAGES = [{"role": "user", "content": "Reply with a short answer: what is 2+2?"}]


@pytest.fixture(scope="module")
def clients():
    jax_backend = TpuBackend(model="tiny", engine=shared_engine("tiny", kv_layout="paged"))
    jax_client = JaxKLLMs(backend=jax_backend)
    port = KLLMs(backend="cuda", model="tiny", device="cpu")
    engine = port.backend.engine
    engine.params = params_from_numpy(
        jax.device_get(shared_params(jax_get_config("tiny"), 0)), engine.config
    )
    yield jax_client, port
    jax_client.close()


def test_create_greedy_matches_jax_client(clients):
    jax_client, port = clients
    kw = dict(messages=MESSAGES, model="tiny", n=4, temperature=0, seed=7, max_tokens=24)
    ref = jax_client.chat.completions.create(**kw)
    out = port.chat.completions.create(**kw)
    assert len(out.choices) == len(ref.choices) == 5
    assert [c.message.content for c in out.choices] == [c.message.content for c in ref.choices]
    assert [c.finish_reason for c in out.choices] == [c.finish_reason for c in ref.choices]
    assert out.usage.model_dump() == ref.usage.model_dump()
    assert json.dumps(out.likelihoods, sort_keys=True) == json.dumps(ref.likelihoods, sort_keys=True)
    np.testing.assert_allclose(
        [c.sample_logprob for c in out.choices[1:]],
        [c.sample_logprob for c in ref.choices[1:]], atol=1e-4, rtol=0,
    )


def test_create_with_stop_and_logprobs(clients):
    jax_client, port = clients
    kw = dict(messages=MESSAGES, model="tiny", n=2, temperature=0, seed=3, max_tokens=16,
              stop=["e"], logprobs=True, top_logprobs=2)
    ref = jax_client.chat.completions.create(**kw)
    out = port.chat.completions.create(**kw)
    assert [c.message.content for c in out.choices] == [c.message.content for c in ref.choices]
    assert out.usage.model_dump() == ref.usage.model_dump()
    ref_toks = [e.token for e in ref.choices[1].logprobs.content]
    assert [e.token for e in out.choices[1].logprobs.content] == ref_toks


def test_parse_validates_after_the_fact(clients):
    _, port = clients

    class Answer(pydantic.BaseModel):
        value: int

    out = port.chat.completions.parse(messages=MESSAGES, response_format=Answer, n=2,
                                      temperature=0, max_tokens=8, seed=1)
    assert len(out.choices) == 3


def test_no_card_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KLLMs(backend="cuda", model="tiny")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "from k_llms_tpu_torch import KLLMs\n"
        "c = KLLMs(backend='cuda', model='tiny', device='cpu')\n"
        "r = c.chat.completions.create(messages=[{'role': 'user', 'content': 'hi'}],"
        " n=4, temperature=0, seed=7, max_tokens=8)\n"
        "assert len(r.choices) == 5 and r.likelihoods is not None\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'k_llms_tpu' or m.startswith('k_llms_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("clean")
