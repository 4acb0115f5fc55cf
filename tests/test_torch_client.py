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


def test_backend_knobs_reach_the_engine(monkeypatch):
    """quantization, paged_kv and decode_attention_impl (with the other model
    overrides) reach the engine under the JAX package's names: int4 leaves
    on an int4-eligible config, the dense layout, flash decode."""
    from k_llms_tpu_torch.models import config as config_mod

    eligible = config_mod.get_config("tiny").with_(
        name="tiny-int4-eligible", hidden_size=256, intermediate_size=512, num_heads=4,
        num_kv_heads=2, head_dim=64, vocab_size=384, max_seq_len=128,
    )
    monkeypatch.setitem(config_mod._REGISTRY, eligible.name, eligible)
    port = KLLMs(backend="cuda", model=eligible.name, device="cpu", quantization="int4",
                 paged_kv=False, decode_attention_impl="flash", attention_impl="flash",
                 max_seq_len=96)
    engine = port.backend.engine
    assert engine.quantized == "int4" and engine.kv_layout == "dense"
    assert engine.config.decode_attention_impl == "flash"
    assert engine.config.attention_impl == "flash" and engine.config.max_seq_len == 96
    assert {type(engine.params["layers"][k]).__name__ for k in ("wq", "wk", "w_down")} == {"Q4Tensor"}
    assert type(engine.params["lm_head"]).__name__ == "Q4Tensor"
    out = port.chat.completions.create(messages=MESSAGES, n=4, temperature=0, seed=1, max_tokens=4)
    assert len(out.choices) == 5 and engine.last_launch_stats["kv_layout"] == "dense"
    with pytest.raises(ValueError, match="quantization"):
        KLLMs(backend="cuda", model="tiny", device="cpu", quantization="int3")


@pytest.mark.parametrize("field,value", [("model_parallel", 2), ("sp_decode", True),
                                         ("sp_attention", "ring")])
def test_unported_backend_field_raises(field, value):
    """The mesh fields were the last JAX BackendConfig fields the port had
    not ported: none is left to raise. Each now reaches the backend config
    and the engine, and in a world of one builds no mesh, as the JAX
    engine on one device; a misspelled keyword still raises."""
    from k_llms_tpu_torch.backends.cuda import UNPORTED_FIELDS

    assert not UNPORTED_FIELDS
    client = KLLMs(backend="cuda", model="tiny", device="cpu", **{field: value})
    assert getattr(client.backend.backend_config, field) == value
    assert client.backend.engine.mesh is None
    client.close()
    with pytest.raises(TypeError, match="unknown keyword"):
        KLLMs(backend="cuda", model="tiny", device="cpu", **{field + "_": value})


@pytest.mark.parametrize("field,value", [("prefix_cache_size", 4), ("prefix_cache_min_reuse", 8),
                                         ("kv_pool_pages", 64), ("checkpoint_path", None),
                                         ("speculative", "prompt_lookup"),
                                         ("spec_lookahead", 2)])
def test_moved_fields_are_served(field, value):
    """The fields the checkpoint loader, the prefix cache and speculative
    decoding brought over no longer raise, and reach the backend config."""
    from k_llms_tpu_torch.backends.cuda import UNPORTED_FIELDS

    assert field not in UNPORTED_FIELDS
    client = KLLMs(backend="cuda", model="tiny", device="cpu", **{field: value})
    assert getattr(client.backend.backend_config, field) == value
    if field != "checkpoint_path":
        assert getattr(client.backend.engine, field) == value


#: The scheduler, memory-model, watchdog, poison and tenancy fields, each
#: with a value other than its default and where the backend holds it.
SERVING_FIELDS = {
    "batch_window": (0.25, lambda b: b.scheduler.batch_window),
    "max_queue_weight": (96, lambda b: b.scheduler.max_queue_weight),
    "max_batch_rows": (16, lambda b: b.scheduler.max_rows),
    "drain_timeout": (3.0, lambda b: b.backend_config.drain_timeout),
    "brownout_high_water": (0.5, lambda b: b.scheduler._brownout_high_water),
    "hbm_bytes": (1 << 33, lambda b: b.memory_model.hbm_bytes),
    "hbm_headroom": (0.5, lambda b: b.memory_model.headroom),
    "watchdog_base_s": (3.0, lambda b: b.supervisor.budget_model.base_s),
    "watchdog_per_token_s": (0.25, lambda b: b.supervisor.budget_model._per_token_s),
    "watchdog_multiplier": (2.0, lambda b: b.supervisor.budget_model.multiplier),
    "watchdog_min_budget_s": (5.0, lambda b: b.supervisor.budget_model.min_budget_s),
    "watchdog_max_budget_s": (50.0, lambda b: b.supervisor.budget_model.max_budget_s),
    "max_rebuilds": (5, lambda b: b.supervisor.max_rebuilds),
    "poison_threshold": (0.25, lambda b: b.supervisor.poison_threshold),
    "poison_window": (3, lambda b: b.supervisor._poison_history.maxlen),
    "tenant_default_weight": (2.0, lambda b: b.tenancy.resolve(None).weight),
    "tenant_default_slo": ("batch", lambda b: b.tenancy.resolve(None).slo),
    "tenant_default_requests_per_s": (7.0, lambda b: b.tenancy.resolve(None).spec.requests_per_s),
    "tenant_default_rows_per_s": (9.0, lambda b: b.tenancy.resolve(None).spec.rows_per_s),
    "tenants": ({"gold": {"weight": 3.0}}, lambda b: {"gold": {"weight": b.tenancy.resolve("gold").weight}}),
    "tenant_api_keys": ({"sk-1": "gold"}, lambda b: {"sk-1": b.tenancy.tenant_for_key("sk-1")}),
}


@pytest.mark.parametrize("field", sorted(SERVING_FIELDS))
def test_serving_fields_take_the_jax_defaults_and_reach_their_layer(field):
    """The 21 fields of the scheduler and supervisor slice are served under
    the JAX package's names and defaults, and a value reaches its layer."""
    from k_llms_tpu.backends.tpu import BackendConfig as JaxBackendConfig
    from k_llms_tpu_torch.backends.cuda import UNPORTED_FIELDS, BackendConfig

    assert field not in UNPORTED_FIELDS
    assert BackendConfig.model_fields[field].default == JaxBackendConfig.model_fields[field].default
    value, read = SERVING_FIELDS[field]
    client = KLLMs(backend="cuda", model="tiny", device="cpu", **{field: value})
    assert read(client.backend) == value
    client.close()


#: The streaming and HTTP serving fields, each with a value other than its
#: default; the serving app and the batch lane read them off the backend's
#: config.
APP_FIELDS = {"sse_ping_interval_s": 0.5, "debug_endpoints": True, "batch_store_dir": "jobs",
              "batch_max_in_flight": 2, "batch_item_retries": 3, "jobstore_ttl_s": 60.0}


@pytest.mark.parametrize("field", sorted(APP_FIELDS))
def test_serving_app_fields_take_the_jax_defaults(field):
    """The six fields of the streaming and HTTP serving slice are served
    under the JAX package's names and defaults, and a value reaches the
    backend's config, where the serving app reads it."""
    from k_llms_tpu.backends.tpu import BackendConfig as JaxBackendConfig
    from k_llms_tpu_torch.backends.cuda import UNPORTED_FIELDS, BackendConfig

    assert field not in UNPORTED_FIELDS
    assert BackendConfig.model_fields[field].default == JaxBackendConfig.model_fields[field].default
    client = KLLMs(backend="cuda", model="tiny", device="cpu", **{field: APP_FIELDS[field]})
    assert getattr(client.backend.backend_config, field) == APP_FIELDS[field]
    client.close()


def test_unported_field_list_matches_the_jax_backend_config():
    """The port's list of unported fields, with the fields it serves, is the
    JAX package's BackendConfig (the port adds only ``device``)."""
    from k_llms_tpu.backends.tpu import BackendConfig as JaxBackendConfig
    from k_llms_tpu_torch.backends.cuda import UNPORTED_FIELDS, BackendConfig

    port_fields = set(BackendConfig.model_fields) - {"device"}
    assert not UNPORTED_FIELDS & port_fields
    assert UNPORTED_FIELDS | port_fields == set(JaxBackendConfig.model_fields)


def test_unknown_backend_kwarg_raises():
    """A keyword that is no BackendConfig field at all (a misspelling) raises
    and names itself; it is never dropped."""
    with pytest.raises(TypeError, match="quantisation"):
        KLLMs(backend="cuda", model="tiny", device="cpu", quantisation="int4")


def test_no_card_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KLLMs(backend="cuda", model="tiny")


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    """Seeded, and from an HF checkpoint directory written by the port's
    own writer (config.json and two shards): the checkpoint loads through
    the port's safetensors reader, with neither ``safetensors`` nor
    ``transformers`` imported, and the prefix cache serves a repeat; the
    key aligner, the device consensus, the continuous loop (its greedy
    answer equal to the coalesced one), the observability layer and the
    HTTP front door (a stream over a real socket) and the train step (one
    step of a seeded tree), the OpenAI passthrough (which raises
    ``ImportError`` without the ``openai`` package) and the quality eval
    import neither either, nor does the lint (``python -m k_llms_tpu_torch.analysis --check``, run in
    the same process, clean over the package)."""
    code = (
        "import json, os, sys\n"
        "import torch\n"
        "from k_llms_tpu_torch import KLLMs\n"
        "from k_llms_tpu_torch.models.safetensors_io import save_file\n"
        "c = KLLMs(backend='cuda', model='tiny', device='cpu')\n"
        "r = c.chat.completions.create(messages=[{'role': 'user', 'content': 'hi'}],"
        " n=4, temperature=0, seed=7, max_tokens=8)\n"
        "assert len(r.choices) == 5 and r.likelihoods is not None\n"
        "cfg, p = c.backend.engine.config, c.backend.engine.params\n"
        f"d = {str(tmp_path / 'mini-hf')!r}\n"
        "os.makedirs(d)\n"
        "names = {'wq': 'self_attn.q_proj', 'wk': 'self_attn.k_proj', 'wv': 'self_attn.v_proj',"
        " 'wo': 'self_attn.o_proj', 'w_gate': 'mlp.gate_proj', 'w_up': 'mlp.up_proj',"
        " 'w_down': 'mlp.down_proj'}\n"
        "t = {'model.embed_tokens.weight': p['embed'], 'model.norm.weight': p['final_norm'],"
        " 'lm_head.weight': p['lm_head'].t()}\n"
        "for i in range(cfg.num_layers):\n"
        "    for ours, hf in names.items():\n"
        "        t[f'model.layers.{i}.{hf}.weight'] = p['layers'][ours][i].t()\n"
        "    t[f'model.layers.{i}.input_layernorm.weight'] = p['layers']['attn_norm'][i]\n"
        "    t[f'model.layers.{i}.post_attention_layernorm.weight'] = p['layers']['mlp_norm'][i]\n"
        "keys = sorted(t)\n"
        "for s in range(2):\n"
        "    save_file({k: t[k] for k in keys[s::2]}, f'{d}/model-0000{s + 1}-of-00002.safetensors')\n"
        "json.dump({'model_type': 'llama', 'vocab_size': cfg.vocab_size,"
        " 'hidden_size': cfg.hidden_size, 'intermediate_size': cfg.intermediate_size,"
        " 'num_hidden_layers': cfg.num_layers, 'num_attention_heads': cfg.num_heads,"
        " 'num_key_value_heads': cfg.num_kv_heads, 'head_dim': cfg.head_dim,"
        " 'rope_theta': cfg.rope_theta, 'max_position_embeddings': cfg.max_seq_len,"
        " 'bos_token_id': cfg.bos_token_id, 'eos_token_id': cfg.eos_token_id,"
        " 'pad_token_id': cfg.pad_token_id, 'torch_dtype': 'float32'}, open(f'{d}/config.json', 'w'))\n"
        "h = KLLMs(backend='cuda', model=d, checkpoint_path=d, device='cpu', dtype='float32',"
        " prefix_cache_size=2)\n"
        "for _ in range(2):\n"
        "    r2 = h.chat.completions.create(messages=[{'role': 'user', 'content': 'hi'}],"
        " n=4, temperature=0, seed=7, max_tokens=8)\n"
        "    assert [x.message.content for x in r2.choices] == [x.message.content for x in r.choices]\n"
        "assert h.backend.engine.prefix_cache_stats == {'hits': 1, 'partial_hits': 0, 'misses': 1}\n"
        "assert h.backend.param_summary['num_leaves'] == 12\n"
        "from k_llms_tpu_torch.backends.base import ChatRequest\n"
        "from k_llms_tpu_torch.engine.scheduler import EngineScheduler\n"
        "from k_llms_tpu_torch.reliability import drills, failpoints\n"
        "from k_llms_tpu_torch.reliability.replicas import ReplicaSet\n"
        "from k_llms_tpu_torch.reliability.supervisor import EngineSupervisor\n"
        "assert isinstance(h.backend.scheduler, EngineScheduler)\n"
        "assert isinstance(h.backend.supervisor, EngineSupervisor)\n"
        "rs = ReplicaSet(members=[c.backend, h.backend], model='tiny', hedge=False)\n"
        "down = {'replica.dispatch': failpoints.FailSpec(action='down', member='r0', times=1)}\n"
        "with failpoints.failpoints(down):\n"
        "    r3 = rs.dispatch_chat_completion(ChatRequest(messages=[{'role': 'user', 'content': 'hi'}],"
        " model='tiny', n=4, temperature=0, seed=7, max_tokens=8))\n"
        "assert [x.message.content for x in r3.choices] == [x.message.content for x in r.choices[1:]]\n"
        "from k_llms_tpu_torch import keyalign\n"
        "from k_llms_tpu_torch.consensus import device as device_consensus\n"
        "from k_llms_tpu_torch.ops import levenshtein\n"
        "lp = KLLMs(backend='cuda', model='tiny', device='cpu', continuous_batching=True,"
        " continuous_width=4, continuous_max_prompt=128, continuous_max_new=16)\n"
        "r4 = lp.chat.completions.create(messages=[{'role': 'user', 'content': 'hi'}],"
        " n=4, temperature=0, seed=7, max_tokens=8)\n"
        "assert [x.message.content for x in r4.choices] == [x.message.content for x in r.choices]\n"
        "assert lp.backend.health()['continuous']['admitted'] == 1\n"
        "assert lp.backend.health()['consensus']['events']['consensus.device_dispatch'] >= 1\n"
        "lp.close()\n"
        "import asyncio, http.client\n"
        "from k_llms_tpu_torch import observability\n"
        "from k_llms_tpu_torch.serving import ServerThread, create_app\n"
        "with ServerThread(create_app(c)) as srv:\n"
        "    conn = http.client.HTTPConnection('127.0.0.1', srv.port, timeout=60)\n"
        "    conn.request('POST', '/v1/chat/completions', body=json.dumps({'messages':"
        " [{'role': 'user', 'content': 'hi'}], 'n': 4, 'temperature': 0, 'seed': 7,"
        " 'max_tokens': 8, 'stream': True}), headers={'content-type': 'application/json'})\n"
        "    sse = conn.getresponse().read()\n"
        "    conn.close()\n"
        "assert sse.endswith(b'data: [DONE]\\n\\n') and b'chat.completion.chunk' in sse\n"
        "assert observability.TRACER is not None\n"
        "from k_llms_tpu_torch.parallel import collectives, controller, distributed, mesh, sharding\n"
        "from k_llms_tpu_torch.ops import ring_attention\n"
        "from k_llms_tpu_torch.engine import long_context\n"
        "assert distributed.initialize_multihost() is False\n"
        "from k_llms_tpu_torch.engine.training import make_train_step\n"
        "from k_llms_tpu_torch.models.llama import init_params\n"
        "tp = init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "init_state, step = make_train_step(cfg)\n"
        "tp, st, loss = step(tp, init_state(tp), torch.randint(0, 256, (2, 16)), torch.ones(2, 16))\n"
        "assert loss.dim() == 0 and bool(torch.isfinite(loss))\n"
        "import importlib.util\n"
        "from k_llms_tpu_torch.backends.openai_backend import OpenAIBackend\n"
        "if importlib.util.find_spec('openai') is None:\n"
        "    try:\n"
        "        KLLMs(backend='openai')\n"
        "        raise AssertionError('backend=openai built without the openai package')\n"
        "    except ImportError as e:\n"
        "        assert 'requires the openai package' in str(e), e\n"
        "from k_llms_tpu_torch.utils.quality import consensus_quality_eval\n"
        "q = consensus_quality_eval(n_values=(3,), trials=2, seed=1)\n"
        "assert 0 < q['consensus_n3'] <= 1 and q['truth_docs'] == 3, q\n"
        "from k_llms_tpu_torch.analysis.__main__ import main as lint\n"
        "assert lint(['--check']) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'k_llms_tpu' or m.startswith('k_llms_tpu.')"
        " or m.split('.')[0] in ('safetensors', 'transformers'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("clean")
