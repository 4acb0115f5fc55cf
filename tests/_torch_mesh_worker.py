"""Gloo worlds of spawned ranks for the port's mesh tests.

A :class:`World` spawns ``size`` processes that join one ``torch.distributed``
world over gloo (a ``FileStore`` rendezvous under the test's temporary
directory, so concurrent files never race for a port) and then serve cases
through queues: ``world.run("case", **kwargs)`` hands every rank the same
case and returns the ranks' results in rank order. A case is a function of
this module named ``case_<name>(rank, **kwargs)``; it runs the port as a
user would, one rank of an SPMD program, and returns numpy values.

This module imports torch and the port only, never JAX: the ranks are the
port's processes. The JAX references are computed in the test process.
"""

from __future__ import annotations

import copy
import os
import queue
import time
import traceback
from datetime import timedelta
from typing import Any, Dict, List

import numpy as np
import torch

CASE_TIMEOUT_S = 240.0


class World:
    """``size`` spawned ranks of one gloo world, serving cases in order."""

    def __init__(self, size: int, store_dir: str, env: Dict[str, str] | None = None):
        ctx = torch.multiprocessing.get_context("spawn")
        self.size = size
        self._in = [ctx.Queue() for _ in range(size)]
        self._out = ctx.Queue()
        store = os.path.join(str(store_dir), "world_store")
        self._procs = [
            ctx.Process(target=_main, args=(r, size, store, self._in[r], self._out, env or {}),
                        daemon=True)
            for r in range(size)
        ]
        for p in self._procs:
            p.start()

    def run(self, case: str, expect_exit: Dict[int, int] | None = None, **kwargs) -> List[Any]:
        """Every rank's result of ``case``, in rank order. A rank in
        ``expect_exit`` must instead end its process with that exit code
        (its result is the code); the world is then broken, and closed."""
        expect_exit = expect_exit or {}
        for q in self._in:
            q.put((case, kwargs))
        results: Dict[int, Any] = {}
        errors = []
        deadline = time.monotonic() + CASE_TIMEOUT_S
        while len(results) + len(errors) < self.size:
            try:
                rank, ok, payload = self._out.get(timeout=1.0)
            except queue.Empty:
                for r, code in expect_exit.items():
                    if r not in results and self._procs[r].exitcode == code:
                        results[r] = code
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in expect_exit]
                if dead or time.monotonic() > deadline:
                    self.close()
                    raise RuntimeError(
                        f"world case {case!r}: ranks {dead} died" if dead
                        else f"world case {case!r}: a rank did not answer"
                    ) from None
                continue
            if ok:
                results[rank] = payload
            else:
                errors.append((rank, payload))
        if errors:
            raise RuntimeError(
                "\n".join(f"rank {r} failed case {case!r}:\n{tb}" for r, tb in errors)
            )
        if expect_exit:
            self.close()
        return [results[r] for r in range(self.size)]

    def close(self) -> None:
        for q in self._in:
            try:
                q.put(None)
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()


def _main(rank, size, store, inq, outq, env) -> None:
    os.environ.update(env)
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=size,
        timeout=timedelta(seconds=120),
    )
    try:
        while True:
            item = inq.get()
            if item is None:
                break
            case, kwargs = item
            try:
                outq.put((rank, True, globals()[f"case_{case}"](rank, **kwargs)))
            except BaseException:
                outq.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# -- helpers ------------------------------------------------------------------

_MESHES: Dict[tuple, Any] = {}


def mesh(shape):
    """The world's (data, model) mesh of ``shape``, made once per world. A
    shape smaller than the world is one of ``world // (data * model)``
    identical replicas of that mesh (a leading ``replica`` axis of the
    device mesh), each rank in the replica its rank order gives it."""
    import torch.distributed as dist

    from k_llms_tpu_torch.parallel.mesh import AXES, Mesh, make_mesh

    shape = tuple(shape)
    if shape not in _MESHES:
        world = dist.get_world_size()
        if shape[0] * shape[1] == world:
            _MESHES[shape] = make_mesh(*shape)
        else:
            from torch.distributed.device_mesh import init_device_mesh

            dm = init_device_mesh("cpu", (world // (shape[0] * shape[1]), *shape),
                                  mesh_dim_names=("replica", *AXES))
            _MESHES[shape] = Mesh(*shape, dm[AXES], transport=dist.get_backend())
    return _MESHES[shape]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _result(r) -> Dict[str, Any]:
    return {
        "tokens": np.asarray(r.tokens),
        "logprobs": np.asarray(r.logprobs),
        "finish_reasons": list(r.finish_reasons),
        "lengths": np.asarray(r.lengths),
        "top_tokens": None if r.top_tokens is None else np.asarray(r.top_tokens),
        "spec_stats": r.spec_stats,
    }


# -- cases --------------------------------------------------------------------

def case_collectives(rank, shape):
    """psum, pmax, all_gather, ppermute and all_to_all over each axis."""
    from k_llms_tpu_torch.parallel import collectives as C

    m = mesh(shape)
    out = {}
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    for axis in ("data", "model"):
        out[axis] = {
            "psum": _np(C.psum(x, axis, m)),
            "pmax": _np(C.pmax(x, axis, m)),
            "all_gather": _np(C.all_gather(x, axis, m, dim=1)),
            "ppermute": _np(C.ppermute(x, axis, m)),
            "all_to_all": _np(C.all_to_all(
                torch.arange(4 * m.axis_size(axis), dtype=torch.float32)[None] + 100 * rank,
                axis, m, split_dim=1, concat_dim=0)),
            "index": m.axis_index(axis),
        }
    return out


def case_w4_tp(rank, shape, x, q, scale, part):
    """w4_matmul_tp_plain on this rank's blocks of a full problem: rows over
    data when they divide (else replicated), the weight cut by ``part``."""
    from k_llms_tpu_torch.ops.w4matmul import Q4Tensor, w4_matmul_tp, w4_matmul_tp_plain
    from k_llms_tpu_torch.parallel.sharding import P, shard_leaf

    m = mesh(shape)
    x, q, scale = torch.as_tensor(x), torch.as_tensor(q), torch.as_tensor(scale)
    rows_axis = "data" if x.shape[0] % m.axis_size("data") == 0 else None
    if part == "col":
        xs = shard_leaf(x, P(rows_axis, None), m)
        wspec = P(None, "model")
    else:
        xs = shard_leaf(x, P(rows_axis, "model"), m)
        wspec = P("model", None)
    w = Q4Tensor(shard_leaf(q, wspec, m), shard_leaf(scale, wspec, m), part=part, mesh=m)
    plain = w4_matmul_tp_plain(xs, w)
    routed = w4_matmul_tp(xs, w)  # on CPU tensors: the same plain product
    return {"out": _np(plain), "routed_equal": bool(torch.equal(plain, routed)),
            "coords": (m.axis_index("data"), m.axis_index("model")), "rows_axis": rows_axis}


def case_ring_attention(rank, shape, q, k, v, causal):
    from k_llms_tpu_torch.ops.ring_attention import ring_attention
    from k_llms_tpu_torch.parallel.sharding import P, shard_leaf

    m = mesh(shape)
    spec = P(None, None, "data", None)
    qs, ks, vs = (shard_leaf(torch.as_tensor(t), spec, m) for t in (q, k, v))
    return _np(ring_attention(m, qs, ks, vs, seq_axis="data", causal=causal))


def case_ring_decode(rank, shape, q, pk, pv, plen, verify=False):
    """ring_decode_prefix (or ring_verify_prefix) on this rank's rows and
    prefix chunk; returns the rank's (out, m, l) blocks."""
    from k_llms_tpu_torch.ops.ring_attention import ring_decode_prefix, ring_verify_prefix
    from k_llms_tpu_torch.parallel.sharding import P, shard_leaf

    m = mesh(shape)
    q = torch.as_tensor(q)
    qspec = P("data", "model", None, None) if verify else P("data", "model", None)
    kvspec = P(None, "data", "model", None)
    fn = ring_verify_prefix if verify else ring_decode_prefix
    out = fn(m, shard_leaf(q, qspec, m), shard_leaf(torch.as_tensor(pk), kvspec, m),
             shard_leaf(torch.as_tensor(pv), kvspec, m), plen)
    return tuple(_np(t) for t in out)


def case_suffix_prefix(rank, shape, q, pk, pv, plen):
    from k_llms_tpu_torch.ops.ring_attention import suffix_prefix_attention
    from k_llms_tpu_torch.parallel.sharding import P, shard_leaf

    m = mesh(shape)
    kvspec = P(None, "data", "model", None)
    out = suffix_prefix_attention(
        m, shard_leaf(torch.as_tensor(q), P(None, "model", None, None), m),
        shard_leaf(torch.as_tensor(pk), kvspec, m), shard_leaf(torch.as_tensor(pv), kvspec, m),
        plen)
    return tuple(_np(t) for t in out)


def case_scatter_ring(rank, shape, buf, suf, start, total):
    from k_llms_tpu_torch.ops.ring_attention import scatter_into_ring
    from k_llms_tpu_torch.parallel.sharding import P, shard_leaf

    m = mesh(shape)
    out = scatter_into_ring(
        m, shard_leaf(torch.as_tensor(buf), P(None, "data", "model", None), m),
        shard_leaf(torch.as_tensor(suf), P(None, None, "model", None), m), start, total)
    return _np(out)


def case_sp_forward(rank, shape, config, params, tokens, attention="ring"):
    """forward_sequence_parallel on this rank's chunk: (logits, hidden, k,
    v) blocks, or the raised exception's type and message."""
    from k_llms_tpu_torch.engine.long_context import forward_sequence_parallel
    from k_llms_tpu_torch.parallel.sharding import shard_params

    m = mesh(shape)
    try:
        logits, h, kv = forward_sequence_parallel(
            config, shard_params(params, m, config), torch.as_tensor(tokens), m,
            attention=attention)
    except (ValueError, NotImplementedError) as e:
        return {"error": type(e).__name__, "message": str(e)}
    return {"logits": _np(logits), "h": _np(h), "k": _np(kv.k), "v": _np(kv.v)}


def case_model_fn(rank, shape, config, params, fn, args):
    """A models/llama.py entry point on this rank's shard of ``params``."""
    from k_llms_tpu_torch.models import llama
    from k_llms_tpu_torch.parallel.sharding import shard_params

    m = mesh(shape)
    sharded = shard_params(params, m, config)
    args = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    out = getattr(llama, fn)(config, sharded, *args)
    if isinstance(out, tuple):
        return [_np(o) if isinstance(o, torch.Tensor) else tuple(_np(t) for t in o) for o in out]
    return _np(out)


_ENGINES: Dict[Any, Any] = {}


def case_engine(rank, shape, config, params, engine_kwargs, calls, key=None, fresh=False):
    """Build (or reuse, by ``key``) an engine on the world's mesh of
    ``shape`` (None: the engine's own auto mesh) over ``params`` (a port
    tree; None: seeded), then run ``calls``: a list of (method, args,
    kwargs) on the engine, or ("attr", name) to read an attribute. Returns
    one value per call."""
    from k_llms_tpu_torch.engine.engine import GenRequestSpec, LocalEngine

    eng = _ENGINES.get(key) if key is not None and not fresh else None
    if eng is None:
        m = mesh(shape) if shape is not None else None
        eng = LocalEngine(config, params=params, device="cpu", mesh=m, **engine_kwargs)
        if key is not None:
            _ENGINES[key] = eng
    out = []
    for call in calls:
        if call[0] == "collectives":  # the collective counts, then reset
            from k_llms_tpu_torch.parallel import collectives as C

            out.append(dict(C.COLLECTIVE_COUNTS))
            C.reset_collective_counts()
            continue
        if call[0] == "fn":  # ("fn", name, args): a helper below on the engine
            out.append(globals()[f"_eng_{call[1]}"](eng, *call[2]))
            continue
        if call[0] == "attr":
            val = getattr(eng, call[1])
            out.append(dict(val) if isinstance(val, dict) else val)
            continue
        if call[0] == "leaf":  # ("leaf", key, attr) of the parameter tree
            node = eng.params["layers"].get(call[1], eng.params.get(call[1]))
            out.append(getattr(node, call[2]) if call[2] else type(node).__name__)
            continue
        method, args, kwargs = call
        if method == "generate_many":
            args = ([GenRequestSpec(*a) for a in args[0]],)
        res = getattr(eng, method)(*args, **kwargs)
        if method == "generate":
            out.append(_result(res))
        elif method == "generate_many":
            out.append([_result(r) if not isinstance(r, BaseException) else repr(r) for r in res])
        elif method == "_prefill_full":
            fl, kv = res
            out.append({"logits": _np(fl), "type": type(kv).__name__,
                        "k": _np(kv.k), "v": _np(kv.v)})
        else:
            out.append(_np(res))
    return out


def case_engine_error(rank, shape, config, params, engine_kwargs):
    """The exception building an engine raises: (type, message)."""
    from k_llms_tpu_torch.engine.engine import LocalEngine

    try:
        LocalEngine(config, params=params, device="cpu", mesh=mesh(shape), **engine_kwargs)
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def case_rank_check(rank, shape, perturb_rank):
    """assert_ranks_agree on equal tokens, then with one rank's perturbed."""
    from k_llms_tpu_torch.parallel.collectives import RankDivergenceError, assert_ranks_agree

    m = mesh(shape)
    tok = torch.arange(8)
    assert_ranks_agree(tok, m, "tokens")
    if rank == perturb_rank:
        tok = tok.clone()
        tok[3] += 1
    try:
        assert_ranks_agree(tok, m, "tokens")
    except RankDivergenceError as e:
        return str(e)
    return None


def case_client(rank, engine_kwargs, request, rank_check=True):
    """A KLLMs client in every rank (its engine builds the auto mesh of the
    world): the controller (rank 0) makes one create() call and the others
    serve it (their constructors return after its close()). Returns the
    controller's texts, and each follower's count of plans run."""
    from k_llms_tpu_torch import KLLMs

    client = KLLMs(backend="cuda", device="cpu", **engine_kwargs)
    backend = client.backend
    if not backend.is_controller:
        return {"follower": True, "plans": backend.controller.plans}
    backend.engine.rank_check = rank_check
    try:
        r = client.chat.completions.create(**request)
        mesh_shape = backend.engine.mesh.shape if backend.engine.mesh else None
        return {"texts": [c.message.content for c in r.choices], "mesh": mesh_shape}
    finally:
        client.close()


def case_controller(rank, shape, config, params, script, engine_kwargs=None,
                    backend_kwargs=None, script_kwargs=None, follower_failpoints=None,
                    seeded=False):
    """A port backend on every rank over ``params`` on the world's mesh of
    ``shape``: rank 0 is the controller and runs ``_ctl_<script>(client,
    **script_kwargs)`` (and closes the client); every other rank is a
    follower, served until that close, with ``follower_failpoints`` (site:
    FailSpec keywords) armed in its process. A rebuild builds the engine
    again over ``params`` on the backend's mesh; with ``seeded`` the backend
    builds its own seeded engines (the world's auto mesh). The controller
    returns its script's value; a follower its plan count, its rebuild
    count, its engine's last launch stats and its replica loop's stats, as
    the hooks recorded them, and every rank how many device meshes it made
    (``mesh_inits``)."""
    import contextlib

    import torch.distributed.device_mesh as dmesh

    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.backends.cuda import BackendConfig, CudaBackend
    from k_llms_tpu_torch.engine.engine import LocalEngine
    from k_llms_tpu_torch.parallel.controller import register_hook
    from k_llms_tpu_torch.reliability import failpoints as fp

    _SNAPSHOTS.clear()
    inits = []
    made = dmesh.init_device_mesh

    def counted(*a, **kw):
        inits.append(a)
        return made(*a, **kw)

    class Backend(CudaBackend):
        def _build_engine(self):
            return LocalEngine(config, params=params, device="cpu", mesh=self._mesh,
                               **(engine_kwargs or {}))

    register_hook("snapshot", lambda e: _SNAPSHOTS.append(_stats(e.last_launch_stats)))
    register_hook("loop_snapshot",
                  lambda e: _SNAPSHOTS.append(_loop_stats(e.host_controller.loop)))
    armed = contextlib.nullcontext()
    if rank != 0 and follower_failpoints:
        armed = fp.failpoints({site: fp.FailSpec(**kw)
                               for site, kw in follower_failpoints.items()})
    dmesh.init_device_mesh = counted
    try:
        with armed:
            bcfg = BackendConfig(model="tiny", device="cpu", **(backend_kwargs or {}))
            if seeded:
                backend = CudaBackend(config=bcfg)
            else:
                eng = LocalEngine(config, params=params, device="cpu", mesh=mesh(shape),
                                  **(engine_kwargs or {}))
                backend = Backend(config=bcfg, engine=eng)
                del eng
        if not backend.is_controller:
            return {"follower": True, "plans": backend.controller.plans,
                    "rebuilds": backend.controller.rebuilds, "snapshots": list(_SNAPSHOTS),
                    "mesh_inits": len(inits)}
        client = KLLMs(backend=backend)
        try:
            out = globals()[f"_ctl_{script}"](client, **(script_kwargs or {}))
        finally:
            client.close()
        if isinstance(out, dict):
            out["mesh_inits"] = len(inits)
        return out
    finally:
        dmesh.init_device_mesh = made


# Each rank's engine stats, appended by the "snapshot" hook in plan order.
_SNAPSHOTS: List[Dict[str, Any]] = []


def _stats(st):
    return {k: v for k, v in st.items() if k not in ("prefill_s", "decode_s")}


def _recorded(engine):
    """Wrap ``engine.generate_many`` to record each launch: its members
    (prompt ids, n, seed), its kwargs, its results and launch stats."""
    launches = []
    inner = engine.generate_many

    def recorded(items, **kw):
        out = inner(items, **kw)
        launches.append({
            "members": [(list(it.prompt_ids), it.n, it.seed) for it in items],
            "kw": {k: v for k, v in kw.items() if k != "constraint"},
            "constraint": kw.get("constraint"),
            "results": [_result(r) if not isinstance(r, BaseException) else repr(r) for r in out],
            "stats": _stats(engine.last_launch_stats)})
        return out

    engine.generate_many = recorded
    return launches


def _ctl_coalesce(client, contents, n, seed, max_tokens, temperature):
    """One create() per content from concurrent threads, started together
    inside the scheduler's batch window: the launches they made."""
    import threading

    launches = _recorded(client.backend.engine)
    out = [None] * len(contents)

    def go(i):
        r = client.chat.completions.create(
            messages=[{"role": "user", "content": contents[i]}], n=n, seed=seed + i,
            max_tokens=max_tokens, temperature=temperature)
        out[i] = [c.message.content for c in r.choices]

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(contents))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"texts": out, "launches": launches,
            "plans": client.backend.controller.plans}


def _ctl_parse(client, content, n, seed, max_tokens):
    """One grammar-constrained parse() (a pydantic schema): its parsed
    record, texts and launch."""
    import pydantic

    class Item(pydantic.BaseModel):
        name: str
        qty: int

    launches = _recorded(client.backend.engine)
    r = client.chat.completions.parse(
        messages=[{"role": "user", "content": content}], response_format=Item, n=n,
        seed=seed, max_tokens=max_tokens, temperature=0.0)
    return {"texts": [c.message.content for c in r.choices], "launches": launches}


class _CancelAfter:
    """A request budget that cancels itself at its ``polls``-th poll (built
    lazily: the deadline module is the port's)."""

    def __new__(cls, polls):
        from k_llms_tpu_torch.reliability.deadline import RequestBudget

        class Budget(RequestBudget):
            def __init__(self):
                super().__init__()
                self.polls = 0

            def should_abort(self):
                self.polls += 1
                if self.polls >= polls:
                    self.cancel()
                return super().should_abort()

        return Budget()


def _ctl_abort(client, prompt, n, seed, max_tokens, polls):
    """A coalesced launch of two members through the controller's engine;
    member 0 is cancelled at its ``polls``-th poll (a few steps in). Then
    one more request serves. Returns the members' outcomes, the launch's
    stats and the next request's texts."""
    from k_llms_tpu_torch.engine.engine import GenRequestSpec

    engine = client.backend.engine
    items = [GenRequestSpec(prompt, n, seed, budget=_CancelAfter(polls)),
             GenRequestSpec(prompt[::-1], n, seed + 1)]
    out = engine.generate_many(items, max_new_tokens=max_tokens, temperature=0.7)
    client.backend.controller.hook("snapshot")
    stats = _stats(engine.last_launch_stats)
    nxt = client.chat.completions.create(messages=[{"role": "user", "content": "next"}],
                                         n=2, seed=5, max_tokens=4)
    return {"outcomes": [type(r).__name__ if isinstance(r, BaseException) else _result(r)
                         for r in out],
            "stats": stats, "next": [c.message.content for c in nxt.choices]}


_LOOP_KEYS = ("steps", "row_steps", "admitted", "joined_in_flight", "completed", "aborted",
              "prefill_chunks", "prefill_interleaved", "active_rows", "free_slots", "width")


def _loop_stats(loop):
    """A loop's counters that every rank of a world must share, its
    geometry and its pool's digest."""
    st = loop.stats
    out = {k: st[k] for k in _LOOP_KEYS}
    out["prefill_chunk_tokens"] = loop.prefill_chunk_tokens
    out["pages"] = None if loop._pool is None else loop._pool.allocator.digest()
    return out


def _loop_result(r):
    if isinstance(r, BaseException):
        return {"error": type(r).__name__, "status": getattr(r, "status_code", None),
                "message": str(r)}
    return {"tokens": np.asarray(r.tokens), "logprobs": np.asarray(r.logprobs),
            "lengths": np.asarray(r.lengths)}


def _wait_steps(loop, steps, timeout=60.0):
    deadline = time.monotonic() + timeout
    while loop.stats["steps"] < steps:
        if time.monotonic() > deadline:
            raise TimeoutError(f"the loop did not reach step {steps}")
        time.sleep(0.001)


def _answer(client, request):
    """One create(): its texts, or its error's type, status and message."""
    try:
        r = client.chat.completions.create(**request)
        return {"texts": [c.message.content for c in r.choices]}
    except Exception as e:
        return {"error": type(e).__name__, "status": getattr(e, "status_code", None),
                "message": str(e)}


def _ctl_rebuild(client, requests, failpoint=None, fault_at=0, wake_s=0.0):
    """``requests`` (create() keywords) in order, request ``fault_at`` under
    ``failpoint`` (site, FailSpec keywords), each answered or failed typed;
    then, ``wake_s`` after the first began (when a hung thread has woken on
    the retired engine), the plan count again. Returns the answers, the
    supervisor's stats, the scheduler's state, the controller's plans (after
    the requests and after the wake) and rebuilds, and whether the first
    engine was retired and replaced."""
    import contextlib

    from k_llms_tpu_torch.reliability import failpoints as fp

    backend, ctl = client.backend, client.backend.controller
    first = backend.engine
    t0 = time.monotonic()
    answers = []
    for i, req in enumerate(requests):
        armed = contextlib.nullcontext()
        if i == fault_at and failpoint is not None:
            armed = fp.failpoints({failpoint[0]: fp.FailSpec(**failpoint[1])})
        with armed:
            answers.append(_answer(client, req))
    plans = ctl.plans
    time.sleep(max(0.0, t0 + wake_s - time.monotonic()))
    return {"answers": answers, "supervisor": backend.supervisor.stats(),
            "state": backend.scheduler.state.value, "plans": plans,
            "plans_after_wake": ctl.plans, "rebuilds": ctl.rebuilds,
            "first_retired": first.retired, "replaced": backend.engine is not first,
            "stopped": None if ctl.stopped is None else repr(ctl.stopped)}


def _ctl_retire_race(client, request, sleep_s, rebuild_after_s):
    """One create() whose launch sleeps at its ``engine.launch`` failpoint
    (bound to the engine, not yet announced) while the loop's rebuild path
    (``_rebuild_loop_engine``) replaces the engine across the host after
    ``rebuild_after_s``. Returns the answer, the rebuild count, the plans
    and the supervisor's stats."""
    import threading

    from k_llms_tpu_torch.reliability import failpoints as fp

    backend, ctl = client.backend, client.backend.controller
    first = backend.engine
    rebuild = threading.Timer(rebuild_after_s, backend._rebuild_loop_engine)
    with fp.failpoints({"engine.launch": fp.FailSpec(action="sleep", times=1, delay=sleep_s)}):
        rebuild.start()
        answer = _answer(client, request)
    rebuild.join()
    return {"answer": answer, "rebuilds": ctl.rebuilds, "plans": ctl.plans,
            "first_retired": first.retired, "supervisor": backend.supervisor.stats()}


def _corrupt_pool(loop):
    """Drop a page from the controller's pool between loop operations and
    run the conservation check, which quarantines the pool."""
    with loop.paused():
        loop._pool.allocator.leak(1)
        return loop.stats["pages"]


def _ctl_loop(client, requests, budget_polls=None, bias_at=None, crash_at=None,
              hang_at=None, after=None, corrupt_at=None):
    """Requests into the controller's loop, each submitted once the loop has
    run ``after[i]`` steps (staggered joins), with request ``budget_polls[0]``
    cancelled at its ``budget_polls[1]``-th poll; a logit-bias create()
    (the coalescing path) once the loop ran ``bias_at`` steps; the worker's
    crash failpoint armed at step ``crash_at``, the step's hang failpoint
    at ``hang_at``, or the pool corrupted at step ``corrupt_at``. Then, with
    the loop idle, one more request
    (the world's answer to it, or its error). Returns every result, the
    loop's counters, the controller's plans and the followers' loop
    counters from the ``loop_snapshot`` hook (taken before the last
    request)."""
    import contextlib
    import threading

    from k_llms_tpu_torch.reliability import failpoints as fp

    backend = client.backend
    loop, ctl = backend._continuous, backend.controller
    after = after or [0] * len(requests)
    futures, results = [None] * len(requests), {}
    corrupted = None
    armed = contextlib.ExitStack()
    for i, (ids, kw) in enumerate(requests):
        _wait_steps(loop, after[i])
        budget = None
        if budget_polls is not None and budget_polls[0] == i:
            budget = _CancelAfter(budget_polls[1])
        futures[i] = loop.submit(list(ids), budget=budget, **kw)
        if i == 0 and crash_at is not None:
            _wait_steps(loop, crash_at)
            armed.enter_context(fp.failpoints({"continuous.worker": fp.FailSpec(
                action="crash", times=1)}))
        if i == 0 and hang_at is not None:
            _wait_steps(loop, hang_at)
            armed.enter_context(fp.failpoints({"continuous.step": fp.FailSpec(
                action="hang", times=1, delay=3.0)}))
        if i == 0 and corrupt_at is not None:
            _wait_steps(loop, corrupt_at)
            corrupted = _corrupt_pool(loop)
    biased = None
    if bias_at is not None:
        launches = _recorded(backend.engine)
        _wait_steps(loop, bias_at)
        steps_at = loop.stats["steps"]
        out = {}

        def bias():
            try:
                r = client.chat.completions.create(
                    messages=[{"role": "user", "content": "spell"}], n=2, seed=3,
                    temperature=0.0, max_tokens=6, logit_bias={"65": 5.0})
                out["texts"] = [c.message.content for c in r.choices]
            except Exception as e:  # reported below
                out["error"] = repr(e)

        t = threading.Thread(target=bias)
        t.start()
        t.join(120)
        biased = dict(out, launches=len(launches), steps_at=steps_at,
                      loop_steps_after=loop.stats["steps"])
    for i, f in enumerate(futures):
        try:
            results[i] = _loop_result(f.result(timeout=120))
        except Exception as e:
            results[i] = _loop_result(e)
    armed.close()
    stats = _loop_stats(loop)
    full = dict(loop.stats)
    snap_error = None
    try:
        ctl.hook("loop_snapshot")
    except Exception as e:
        snap_error = repr(e)
    nxt = None
    if requests:
        ids, kw = requests[0]
        try:
            nxt = _loop_result(loop.submit(list(ids), **kw).result(timeout=120))
        except Exception as e:
            nxt = _loop_result(e)
    return {"results": results, "stats": stats, "restarts": full["restarts"],
            "last_recovery_reason": full["last_recovery_reason"], "plans": ctl.plans,
            "biased": biased, "next": nxt, "snapshot_error": snap_error,
            "stopped": None if ctl.stopped is None else repr(ctl.stopped),
            "geometry": loop.geometry(), "rebuilds": ctl.rebuilds, "corrupted": corrupted}


def _ctl_loop_client(client, messages, requests, stream_too=False):
    """``create()`` calls through the controller (each qualifying one rides
    the loop): their texts, and with ``stream_too`` each also streamed,
    its deltas joined per choice. Returns the loop's admissions."""
    loop = client.backend._continuous
    out = []
    for kw in requests:
        r = client.chat.completions.create(messages=messages, **kw)
        rec = {"texts": [c.message.content for c in r.choices]}
        if stream_too:
            deltas = 0
            with client.chat.completions.create(messages=messages, stream=True, **kw) as s:
                for _ in s:
                    deltas += 1
            rec["streamed"] = [c.message.content for c in s.response.choices]
            rec["stream_chunks"] = deltas
        out.append(rec)
    client.backend.controller.hook("loop_snapshot")
    return {"outs": out, "admitted": loop.stats["admitted"], "stats": _loop_stats(loop),
            "plans": client.backend.controller.plans}


def _eng_param_bytes(eng, whole_tree):
    return eng.param_footprint_bytes(whole_tree=whole_tree)


def case_mesh_shapes(rank):
    from k_llms_tpu_torch.parallel.mesh import auto_mesh, make_mesh

    out = {"auto": dict(auto_mesh().shape), "coords": None}
    m = auto_mesh(model_parallel=2)
    out["auto_mp2"] = dict(m.shape)
    out["coords"] = (m.axis_index("data"), m.axis_index("model"))
    for key, fn in (("too_big", lambda: make_mesh(4, 4)),
                    ("mp3", lambda: auto_mesh(model_parallel=3))):
        try:
            fn()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


def case_decode_on_shards(rank, shape, config, params, tokens, prompt_len, n):
    """prefill then one decode step of ``n`` rows on this rank's shard."""
    from k_llms_tpu_torch.models import llama
    from k_llms_tpu_torch.parallel.sharding import shard_params

    m = mesh(shape)
    sharded = shard_params(params, m, config)
    tokens = torch.as_tensor(tokens, dtype=torch.int64)
    _, (k, v) = llama.prefill(config, sharded, tokens, prompt_len)
    kv_cfg = config.with_(num_kv_heads=k.shape[3])
    gen = llama.init_cache(kv_cfg, n, 4, "cpu")
    tk = torch.full((n,), int(tokens[0, prompt_len]), dtype=torch.int64)
    logits, _ = llama.decode_step(config, sharded, tk, 0, torch.tensor([prompt_len]), gen,
                                  llama.KVCache(k=k, v=v))
    return _np(logits)


def _eng_plant_replicated(eng, ids):
    """Store the replicated layout of a prompt's prefill under its key (what
    a replicated-path run sharing the cache would leave behind)."""
    ids, plen, bucket = eng._prep_prompt(ids)
    fl, kv = eng._prefill_full(ids, plen, bucket)
    eng._prefix_store(ids, fl, eng._replicated(kv))
    return eng._kv_seq_sharded(eng._prefix_entries[tuple(ids)][1])


def _eng_entry_layout(eng, ids):
    """(sequence-sharded?, this rank's stored positions) of a cache entry."""
    kv = eng._prefix_entries[tuple(ids)][1]
    return eng._kv_seq_sharded(kv), int(kv.k.shape[2])


def _eng_prefill_routed(eng, ids, bucket):
    fl, kv = eng._prefill_routed(ids, len(ids), bucket)
    return _np(fl)


def _eng_prefill_full_layout(eng, ids, bucket):
    fl, kv = eng._prefill_full(ids, len(ids), bucket)
    return type(kv).__name__, int(kv.k.shape[2]), _np(fl)


def case_train_step(rank, shape, config, params, tokens, mask, steps):
    """``steps`` of the port's train step on this rank's shard of ``params``
    over the mesh of ``shape``, each rank passing the whole batch: the
    losses, each step's collective counts, the forward's counts under
    inference mode, and the rank's updated shard (numpy, by leaf path)."""
    from k_llms_tpu_torch.engine.training import _leaves, make_train_step
    from k_llms_tpu_torch.models import llama
    from k_llms_tpu_torch.parallel import collectives as C
    from k_llms_tpu_torch.parallel.sharding import shard_params

    m = mesh(shape)
    # The tree arrived in memory the ranks share, and a shard keeps the
    # leaves it does not cut: each rank trains its own copy.
    sharded = shard_params(copy.deepcopy(params), m, config)
    C.reset_collective_counts()
    with torch.inference_mode():
        llama.forward(config, sharded, torch.as_tensor(tokens), torch.as_tensor(mask))
    forward_counts = dict(C.COLLECTIVE_COUNTS)
    init_state, step = make_train_step(config, mesh=m)
    opt = init_state(sharded)
    losses, counts = [], []
    for _ in range(steps):
        C.reset_collective_counts()
        sharded, opt, loss = step(sharded, opt, tokens, mask)
        counts.append(dict(C.COLLECTIVE_COUNTS))
        losses.append(loss.item())
    return {"losses": losses, "counts": counts, "forward_counts": forward_counts,
            "coords": (m.axis_index("data"), m.axis_index("model")),
            "params": {path: _np(leaf) for path, leaf in _leaves(sharded)}}


def case_train_error(rank, shape, config, params, tokens, mask):
    """The exception a train step on this rank's shard raises: (type,
    message)."""
    from k_llms_tpu_torch.engine.training import make_train_step
    from k_llms_tpu_torch.parallel.sharding import shard_params

    m = mesh(shape)
    sharded = shard_params(params, m, config)
    init_state, step = make_train_step(config, mesh=m)
    try:
        step(sharded, init_state(sharded), tokens, mask)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None
