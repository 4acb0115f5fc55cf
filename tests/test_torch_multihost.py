"""The port's multi-process start, as the JAX package's
``tests/test_multihost.py`` drives its own: two OS processes initialise
through ``parallel.distributed.initialize_multihost`` from the ``KLLMS_*``
environment (a TCP coordinator on localhost, gloo on the CPU), build one
(1, 2) mesh across both, and run a ``psum`` and a tensor-parallel forward
whose collectives cross the process boundary; the loss is the same on both
and equals the JAX package's forward on the same weights. Also: the mesh
fields in a world of one change nothing, ``sp_attention`` is checked when
the backend is built, and the transport follows the host's ranks."""

import os
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
sys.path.insert(0, os.getcwd())
import torch
torch.set_num_threads(1)
from k_llms_tpu_torch.parallel.distributed import initialize_multihost
from k_llms_tpu_torch.parallel import collectives as C
from k_llms_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
from k_llms_tpu_torch.parallel.sharding import shard_params
import torch.distributed as dist

assert initialize_multihost(device="cpu")
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
pid = dist.get_rank()
mesh = make_mesh(1, 2)
t = C.psum(torch.arange(2, dtype=torch.float32) + 10 * pid, MODEL_AXIS, mesh)
assert t.tolist() == [10.0, 12.0], t

import numpy as np
from k_llms_tpu_torch.models.config import get_config
from k_llms_tpu_torch.models.llama import forward, params_from_numpy
cfg = get_config("tiny")
with np.load(sys.argv[1]) as f:
    arrays = dict(f)
tokens = torch.from_numpy(arrays.pop("tokens"))
tree = {"layers": {}}
for name, arr in arrays.items():
    if name.startswith("layers/"):
        tree["layers"][name[len("layers/"):]] = arr
    else:
        tree[name] = arr
params = params_from_numpy(tree, cfg)
logits, _ = forward(cfg, shard_params(params, mesh, cfg), tokens, torch.ones_like(tokens))
assert C.COLLECTIVE_COUNTS["psum"] == 1 + 2 * cfg.num_layers + 1
loss = float((logits.float() ** 2).mean())
print(f"WORKER_{pid}_LOSS={loss:.9f}")
print(f"WORKER_{pid}_OK")
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(port, weights):
    procs = []
    try:
        for pid in range(2):
            env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
            env.update(KLLMS_COORDINATOR=f"127.0.0.1:{port}", KLLMS_NUM_PROCESSES="2",
                       KLLMS_PROCESS_ID=str(pid))
            procs.append(subprocess.Popen([sys.executable, "-c", WORKER, weights], env=env, cwd=REPO,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=150)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] or "")
        return outs, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def test_two_process_collectives_and_sharded_forward(tmp_path):
    """The processes cut their shards from the JAX package's tiny weights
    (through numpy); their loss is the JAX forward's."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from k_llms_tpu.models import get_config, init_params
    from k_llms_tpu.models.llama import forward

    cfg = get_config("tiny")
    params = jax.device_get(init_params(cfg, jax.random.key(0)))
    tokens = (np.arange(4 * 16).reshape(4, 16) * 7) % cfg.vocab_size
    arrays = {"tokens": tokens.astype(np.int64)}
    for name, leaf in params.items():
        if name == "layers":
            arrays.update({f"layers/{k}": np.asarray(v) for k, v in leaf.items()})
        else:
            arrays[name] = np.asarray(leaf)
    weights = str(tmp_path / "weights.npz")
    np.savez(weights, **arrays)
    for attempt in range(2):
        outputs, procs = _run_workers(_free_port(), weights)
        if all(p.returncode == 0 for p in procs) or attempt == 1:
            break
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"WORKER_{pid}_OK" in out
    losses = [line.split("=")[1] for out in outputs for line in out.splitlines()
              if "_LOSS=" in line]
    assert len(losses) == 2 and losses[0] == losses[1], losses
    logits, _ = forward(cfg, params, jnp.asarray(tokens, jnp.int32), jnp.ones(tokens.shape, jnp.int32))
    want = float(jnp.mean(jnp.square(logits.astype(jnp.float32))))
    assert float(losses[0]) == pytest.approx(want, rel=1e-5)


def test_initialize_multihost_single_process(monkeypatch):
    """No coordinator and no process count: a single process, no group;
    a partial environment is refused."""
    from k_llms_tpu_torch.parallel import distributed

    for name in ("KLLMS_COORDINATOR", "KLLMS_NUM_PROCESSES", "KLLMS_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize_multihost() is False
    assert distributed.world_size() == 1
    monkeypatch.setenv("KLLMS_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="KLLMS_COORDINATOR"):
        distributed.initialize_multihost()
    assert distributed.default_transport("cpu", 2) == "gloo"


def test_default_transport_counts_the_hosts_ranks(monkeypatch):
    """nccl when this host's ranks each have a card: a world of 8 over two
    hosts of 4 cards (LOCAL_WORLD_SIZE 4, or 2 ranks on a host) is nccl;
    ranks that outnumber the host's cards share them, over gloo."""
    from k_llms_tpu_torch.parallel import distributed

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert distributed.local_world_size(8) == 8
    assert distributed.default_transport("cuda", distributed.local_world_size(8), 4) == "gloo"
    for local in (4, 2):
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
        assert distributed.local_world_size(8) == local
        assert distributed.default_transport("cuda", distributed.local_world_size(8), 4) == "nccl"
    assert distributed.default_transport("cuda", 2, 1) == "gloo"
    assert distributed.default_transport("cpu", 1, 4) == "gloo"


def test_mesh_fields_in_a_world_of_one_change_nothing():
    """model_parallel and the SP fields in a world of one: no mesh, and the
    same response as without them (JAX's engine on one device)."""
    from k_llms_tpu_torch import KLLMs

    req = dict(messages=[{"role": "user", "content": "hi"}], n=4, temperature=0.7, seed=7,
               max_tokens=8)
    base = KLLMs(backend="cuda", model="tiny", device="cpu")
    mesh = KLLMs(backend="cuda", model="tiny", device="cpu", model_parallel=2,
                 sp_prefill_min_tokens=8, sp_attention="ulysses", sp_decode=True)
    try:
        assert mesh.backend.engine.mesh is None
        a = base.chat.completions.create(**req)
        b = mesh.chat.completions.create(**req)
        assert [c.message.content for c in a.choices] == [c.message.content for c in b.choices]
        assert a.likelihoods == b.likelihoods
    finally:
        base.close()
        mesh.close()


def test_sp_attention_checked_when_the_backend_is_built():
    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.engine.engine import LocalEngine

    with pytest.raises(ValueError, match="Unknown sp_attention"):
        KLLMs(backend="cuda", model="tiny", device="cpu", sp_attention="bogus")
    with pytest.raises(ValueError, match="Unknown sp_attention"):
        LocalEngine("tiny", device="cpu", use_mesh=False, sp_attention="ulyses")
