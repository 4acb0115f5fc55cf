"""The port's batch job store (``k_llms_tpu_torch/reliability/jobstore.py``, a
copy) held against the JAX package's: twins of ``tests/test_jobstore.py``.

Each scenario runs once per package in its own directory, with the clock
frozen and the job ids given, and must leave the same observable outcome
(job states, counts, outputs, what a reopen recovers) and the same bytes on
disk (journal, input, segments, assembled output). The scenarios cover the
round trip and reopen, error items, the ``batch.store`` failpoint's torn
appends on a started and on a committed item, a garbage tail, a
kill-anywhere truncation sweep of the journal, requeue and late commit,
cancel with partial output, stray and unparsable segments, a missing input
and the TTL sweep.
"""

import json
import os
import shutil
import time

import pytest

from _torch_wire import both

NOW = 1_700_000_000.0


def _items(n):
    return [{"custom_id": f"c{i}", "rid": f"batch_req_{i:024d}",
             "body": {"messages": [{"role": "user", "content": f"q{i}"}], "seed": i}}
            for i in range(n)]


def _record(item, idx, error=False):
    if error:
        return {"id": item["rid"], "custom_id": item["custom_id"], "response": None,
                "error": {"status_code": 400, "message": "boom", "type": "invalid_request_error",
                          "param": None, "code": None}}
    return {"id": item["rid"], "custom_id": item["custom_id"],
            "response": {"status_code": 200, "body": {"idx": idx}}, "error": None}


def _complete(store, items, job_id):
    job = store.create_job(items, tenant="default", job_id=job_id)
    for idx, item in enumerate(items):
        assert store.note_item_started(job.id, idx)
        assert store.commit_item(job.id, idx, _record(item, idx))
    return store.finish_job(job.id)


def _state(store, job_id):
    job = store.job(job_id)
    if job is None:
        return None
    return {"status": job.status, "items": list(job.items), "counts": job.counts(),
            "output": store.read_output(job_id)}


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def round_trip(p, root):
    store = p.jobstore.JobStore(root)
    status = _complete(store, _items(4), "batch_a")
    first = _state(store, "batch_a")
    store.close()
    store2 = p.jobstore.JobStore(root)
    out = [status, first, _state(store2, "batch_a"), [j.id for j in store2.unfinished_jobs()]]
    store2.close()
    return out


def error_items(p, root):
    store = p.jobstore.JobStore(root)
    items = _items(3)
    job = store.create_job(items, tenant="default", job_id="batch_e")
    for idx, item in enumerate(items):
        store.note_item_started(job.id, idx)
        store.commit_item(job.id, idx, _record(item, idx, error=idx == 1), error=idx == 1)
    out = [store.finish_job(job.id), _state(store, job.id)]
    store.close()
    return out


def torn_started(p, root):
    store = p.jobstore.JobStore(root)
    items = _items(2)
    job = store.create_job(items, tenant="default", job_id="batch_t")
    spec = p.fp.FailSpec(action="torn", times=1)
    with p.fp.failpoints({"batch.store": spec}):
        with pytest.raises(RuntimeError, match="torn journal append"):
            store.note_item_started(job.id, 0)
    store.close()
    store2 = p.jobstore.JobStore(root)
    out = [spec._fired, _state(store2, job.id)]
    out.append(_complete_rest(store2, items, job.id))
    store2.close()
    return out


def _complete_rest(store, items, job_id):
    for idx, item in enumerate(items):
        if store.job(job_id).items[idx] == "pending":
            store.note_item_started(job_id, idx)
            store.commit_item(job_id, idx, _record(item, idx))
    return [store.finish_job(job_id), _state(store, job_id)]


def torn_commit(p, root):
    store = p.jobstore.JobStore(root)
    items = _items(2)
    job = store.create_job(items, tenant="default", job_id="batch_c")
    store.note_item_started(job.id, 0)
    spec = p.fp.FailSpec(action="torn", times=1)
    with p.fp.failpoints({"batch.store": spec}):
        with pytest.raises(RuntimeError, match="batch.store"):
            store.commit_item(job.id, 0, _record(items[0], 0))
    store.close()
    store2 = p.jobstore.JobStore(root)
    out = [spec._fired, _state(store2, job.id), _complete_rest(store2, items, job.id)]
    store2.close()
    return out


def garbage_tail(p, root):
    store = p.jobstore.JobStore(root)
    _complete(store, _items(2), "batch_g")
    store.close()
    journal = os.path.join(root, "journal.log")
    with open(journal, "ab") as fh:
        fh.write(b"\x07garbage-partial-frame")
    store2 = p.jobstore.JobStore(root)
    out = [_state(store2, "batch_g")]
    store2.close()
    return out


def truncation_sweep(p, root):
    src = os.path.join(root, "src")
    store = p.jobstore.JobStore(src)
    _complete(store, _items(3), "batch_sweep")
    store.close()
    with open(os.path.join(src, "journal.log"), "rb") as fh:
        size = len(fh.read())
    out = []
    for cut in range(0, size + 1, 7):
        trial = os.path.join(root, f"cut{cut}")
        shutil.copytree(src, trial)
        with open(os.path.join(trial, "journal.log"), "ab") as fh:
            fh.truncate(cut)
        store2 = p.jobstore.JobStore(trial)
        out.append((cut, _state(store2, "batch_sweep")))
        store2.close()
        shutil.rmtree(trial)
    return out


def requeue_late_commit(p, root):
    store = p.jobstore.JobStore(root)
    items = _items(1)
    job = store.create_job(items, tenant="default", job_id="batch_r")
    store.note_item_started(job.id, 0)
    out = [store.requeue_item(job.id, 0), store.job(job.id).items[0],
           store.commit_item(job.id, 0, _record(items[0], 0)), store.finish_job(job.id),
           store.requeue_item(job.id, 0)]
    store.close()
    store2 = p.jobstore.JobStore(root)
    out.append(_state(store2, job.id))
    store2.close()
    return out


def cancel_partial(p, root):
    store = p.jobstore.JobStore(root)
    items = _items(3)
    job = store.create_job(items, tenant="default", job_id="batch_x")
    store.note_item_started(job.id, 0)
    store.commit_item(job.id, 0, _record(items[0], 0))
    out = [store.cancel_job(job.id), store.note_item_started(job.id, 1),
           store.cancel_job(job.id), _state(store, job.id)]
    store.close()
    store2 = p.jobstore.JobStore(root)
    out += [_state(store2, job.id), [j.id for j in store2.unfinished_jobs()]]
    store2.close()
    return out


def bad_segments_and_input(p, root):
    store = p.jobstore.JobStore(root)
    for jid in ("batch_s", "batch_u", "batch_m"):
        store.create_job(_items(1), tenant="default", job_id=jid)
    store.note_item_started("batch_u", 0)
    store.close()
    with open(os.path.join(root, "jobs", "batch_s", "out", "00000.json.tmp"), "wb") as fh:
        fh.write(b'{"half-written":')
    with open(os.path.join(root, "jobs", "batch_u", "out", "00000.json"), "wb") as fh:
        fh.write(b"\x00\xff not json")
    os.unlink(os.path.join(root, "jobs", "batch_m", "input.jsonl"))
    store2 = p.jobstore.JobStore(root)
    out = [_state(store2, jid) for jid in ("batch_s", "batch_u", "batch_m")]
    store2.close()
    return out


def ttl_sweep(p, root):
    store = p.jobstore.JobStore(root)
    _complete(store, _items(2), "batch_old")
    store.create_job(_items(2), tenant="default", job_id="batch_open")
    store.close()
    orphan = os.path.join(root, "jobs", "batch_orphan", "out")
    os.makedirs(orphan)
    swept = p.obs.BATCH_EVENTS.get("batch.job_swept")
    time.time = lambda: NOW + 10.0  # the jobs are 10 s old
    store2 = p.jobstore.JobStore(root, ttl_s=5.0)
    out = [_state(store2, "batch_old"), _state(store2, "batch_open")["status"],
           os.path.exists(os.path.dirname(orphan)),
           p.obs.BATCH_EVENTS.get("batch.job_swept") - swept]
    store2.close()
    store3 = p.jobstore.JobStore(root)
    out.append(_state(store3, "batch_old"))
    store3.close()
    return out


SCENARIOS = {f.__name__: f for f in (round_trip, error_items, torn_started, torn_commit,
                                     garbage_tail, truncation_sweep, requeue_late_commit,
                                     cancel_partial, bad_segments_and_input, ttl_sweep)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_jax(name, tmp_path, monkeypatch):
    outcomes, trees = [], []
    for p in both():
        monkeypatch.setattr(time, "time", lambda: NOW)
        root = tmp_path / p.root
        root.mkdir()
        outcomes.append(SCENARIOS[name](p, str(root)))
        trees.append(_tree(root))
    assert outcomes[1] == outcomes[0]
    assert trees[1] == trees[0]
    json.dumps(outcomes[1], default=repr)  # plain data


def test_terminal_statuses_equal_jax():
    jax, port = both()
    assert port.jobstore.TERMINAL_STATUSES == jax.jobstore.TERMINAL_STATUSES
    assert port.jobstore.ITEM_STATES == jax.jobstore.ITEM_STATES
