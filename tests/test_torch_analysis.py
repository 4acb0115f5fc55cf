"""The port's kllms-check: per-rule fixtures, the CLI contract, and the
tier-1 gate over ``k_llms_tpu_torch``.

Twin of ``tests/test_analysis.py``. Every rule is pinned twice, by a
``bad`` fixture that must fire and a ``good`` one that must stay silent.
The rules whose text the port copies unchanged (``lock-order``, the
``guarded-by`` family, the three contract rules, the suppression
machinery) read the JAX package's fixtures under ``tests/fixtures/lint/``.
The rules the port rewrites for torch (``dispatch-under-lock``'s callees,
``host-sync-hot-path``'s syncs, ``jit-recompile-hygiene``'s compiled
objects) get torch-idiom fixtures, written to ``tmp_path`` below. The
package-wide ``--check`` gate runs over the port with its own configuration
(``k_llms_tpu_torch/analysis/kllms-check.toml``).
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from k_llms_tpu_torch.analysis.framework import (
    CONFIG_FILE,
    DEFAULT_CONFIG,
    RULES,
    _ensure_rules_loaded,
    load_config,
    load_project,
    run_rules,
    unsuppressed,
)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "lint"

EXPECTED_RULES = {
    "lock-order",
    "dispatch-under-lock",
    "host-sync-hot-path",
    "jit-recompile-hygiene",
    "failpoint-coverage",
    "counter-hygiene",
    "wire-error-contract",
    "guarded-by",
    "guarded-by-unguarded",
    "guarded-by-escape",
    "guarded-by-annotation",
}

GUARDED_BY_FAMILY = (
    "guarded-by",
    "guarded-by-unguarded",
    "guarded-by-escape",
    "guarded-by-annotation",
)


def run_fixture(rule_id, rel, config=None, readme=None, test_sources=None, root=FIXTURES):
    """Run one rule over one fixture subtree as a standalone project."""
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    project = load_project(root, paths=[root / rel], config=cfg, with_context=False)
    assert project.files, f"fixture {rel} matched no files"
    assert all(f.parse_error is None for f in project.files)
    project.readme = readme
    project.test_sources = dict(test_sources or {})
    return run_rules(project, [rule_id])


def run_source(tmp_path, rule_id, name, source, config=None):
    """Run one rule over a fixture written to ``tmp_path``."""
    path = tmp_path / name
    path.write_text(textwrap.dedent(source), encoding="utf-8")
    return run_fixture(rule_id, name, config, root=tmp_path)


def messages(findings):
    return [f.message for f in findings if not f.suppressed]


# ---------------------------------------------------------------------------
# registry and configuration
# ---------------------------------------------------------------------------


def test_registry_has_the_jax_suites_rule_ids_with_metadata():
    from k_llms_tpu.analysis.framework import RULES as JAX_RULES
    from k_llms_tpu.analysis.framework import _ensure_rules_loaded as jax_rules_loaded

    _ensure_rules_loaded()
    jax_rules_loaded()
    assert set(RULES) == EXPECTED_RULES == set(JAX_RULES)
    for rid, cls in RULES.items():
        rule = cls()
        assert rule.id == rid
        assert rule.summary and rule.invariant and rule.subsystem, rid


def test_configuration_lives_in_the_package():
    """The port's lint reads its own TOML file, never pyproject.toml's
    ``[tool.kllms-check]`` (the JAX package's section)."""
    assert (REPO / CONFIG_FILE).is_file()
    assert CONFIG_FILE.parts[0] == "k_llms_tpu_torch"
    cfg = load_config(REPO)
    assert cfg["package"] == "k_llms_tpu_torch"
    assert "LocalEngine._decode" in cfg["host-sync-hot-path"]["hot_functions"]
    assert cfg["lock-order"]["owners"]["engine"] == "LocalEngine"
    assert cfg["counter-hygiene"]["metrics_file"] == "serving/app.py"
    assert "tool" not in cfg
    # A root without the package's file (a fixture tree) gets the defaults.
    assert load_config(FIXTURES) == DEFAULT_CONFIG


def test_context_is_the_ports_own_tests():
    project = load_project(REPO)
    assert project.readme is not None
    assert project.test_sources
    assert all(Path(rel).name.startswith("test_torch_") for rel in project.test_sources)
    assert "tests/test_torch_analysis.py" in project.test_sources


# ---------------------------------------------------------------------------
# the rules the port copies: the JAX package's fixtures
# ---------------------------------------------------------------------------


def test_lock_order_bad_fixture_finds_cycle_and_raw_lock():
    msgs = messages(run_fixture("lock-order", "lock-order/bad.py"))
    assert len(msgs) == 2
    cycle = [m for m in msgs if "lock-order cycle" in m]
    assert len(cycle) == 1
    assert "fix.a" in cycle[0] and "fix.b" in cycle[0]
    raw = [m for m in msgs if "threading.Lock()" in m]
    assert len(raw) == 1 and "bad.RAW" in raw[0]


def test_lock_order_good_fixture_is_clean():
    assert messages(run_fixture("lock-order", "lock-order/good.py")) == []


BAD_FP_TESTS = {
    "tests/test_x.py": 'spec = FailSpec(action="error")\nfire("engine.launch")\n'
}
BAD_FP_README = "| `engine.launch` | engine | batched launch |\n"


def test_failpoint_coverage_bad_fixture():
    msgs = messages(
        run_fixture(
            "failpoint-coverage",
            "failpoint-coverage/bad",
            readme=BAD_FP_README,
            test_sources=BAD_FP_TESTS,
        )
    )
    assert len(msgs) == 6
    assert sum("string literal" in m for m in msgs) == 1
    assert sum("'engine.typo' is not registered" in m for m in msgs) == 1
    assert sum("dead registry entry" in m for m in msgs) == 1
    assert sum("exercised by no test" in m for m in msgs) == 1
    assert sum("README registry-table" in m for m in msgs) == 1
    assert sum("'hang' is never" in m for m in msgs) == 1


GOOD_FP_TESTS = {
    "tests/test_x.py": (
        'FailSpec(action="error")\nFailSpec(action="hang")\n'
        'fire("engine.launch")\nfire("engine.pages")\n'
    )
}
GOOD_FP_README = (
    "| `engine.launch` | engine | batched launch |\n"
    "| `engine.pages` | engine | slot page release |\n"
)


def test_failpoint_coverage_good_fixture_is_clean():
    assert (
        messages(
            run_fixture(
                "failpoint-coverage",
                "failpoint-coverage/good",
                readme=GOOD_FP_README,
                test_sources=GOOD_FP_TESTS,
            )
        )
        == []
    )


def test_counter_hygiene_bad_fixture():
    msgs = messages(run_fixture("counter-hygiene", "counter-hygiene/bad"))
    assert len(msgs) == 8
    assert sum("counter group" in m and "without declared=" in m for m in msgs) == 1
    assert sum("'a.typo'" in m for m in msgs) == 1
    assert sum("'stale.name'" in m and "never" in m for m in msgs) == 1
    assert sum("not surfaced" in m and "ALPHA_EVENTS" in m for m in msgs) == 1
    assert sum("histogram group" in m and "without declared=" in m for m in msgs) == 1
    assert sum("'h.typo'" in m for m in msgs) == 1
    assert sum("'stale.hist'" in m and "never observed" in m for m in msgs) == 1
    assert sum("not surfaced" in m and "GAMMA_HIST" in m for m in msgs) == 1


def test_counter_hygiene_good_fixture_is_clean():
    assert messages(run_fixture("counter-hygiene", "counter-hygiene/good")) == []


def test_wire_error_contract_bad_fixture():
    msgs = messages(run_fixture("wire-error-contract", "wire-error-contract/bad.py"))
    assert len(msgs) == 3
    assert sum("BadError" in m and "type, status_code" in m for m in msgs) == 1
    assert sum("PartialError" in m and "status_code" in m for m in msgs) == 1
    assert sum("WorseError.as_wire" in m for m in msgs) == 1


def test_wire_error_contract_good_fixture_is_clean():
    assert messages(run_fixture("wire-error-contract", "wire-error-contract/good.py")) == []


@pytest.mark.parametrize("rid", GUARDED_BY_FAMILY)
def test_guarded_by_good_fixtures_are_clean(rid):
    assert messages(run_fixture(rid, "guarded-by/good")) == []


def test_guarded_by_bad_fixture_flags_minority_declared_and_tie():
    msgs = messages(run_fixture("guarded-by", "guarded-by/bad"))
    assert len(msgs) == 3
    declared = [m for m in msgs if "declared via # kllms: guarded-by" in m]
    assert len(declared) == 1
    assert "Annotated._items" in declared[0] and "Annotated.add" in declared[0]
    inferred = [m for m in msgs if "inferred: held at 2 of 3 access sites" in m]
    assert len(inferred) == 1
    assert "Stats._counts" in inferred[0] and "read in Stats.peek" in inferred[0]
    tie = [m for m in msgs if "cannot infer a guard" in m]
    assert len(tie) == 1
    assert "'fix.torn_a'" in tie[0] and "'fix.torn_b'" in tie[0]


def test_guarded_by_unguarded_bad_fixture_names_every_writer():
    msgs = messages(run_fixture("guarded-by-unguarded", "guarded-by/bad"))
    assert len(msgs) == 1
    assert "Gauge.level is written from 2 methods" in msgs[0]
    assert "Gauge.down, Gauge.up" in msgs[0]


def test_guarded_by_unguarded_min_writers_config_is_load_bearing():
    cfg = {"guarded-by": {"min_write_methods": 3}}
    assert messages(run_fixture("guarded-by-unguarded", "guarded-by/bad", cfg)) == []


def test_guarded_by_ignore_pattern_exempts_attribute():
    cfg = {"guarded-by": {"ignore": ["Stats._*"]}}
    assert messages(run_fixture("guarded-by", "guarded-by/bad/inferred.py", cfg)) == []


def test_guarded_by_escape_bad_fixture():
    msgs = messages(run_fixture("guarded-by-escape", "guarded-by/bad"))
    assert len(msgs) == 2
    assert sum("returned raw from Leaky.raw" in m for m in msgs) == 1
    assert sum("passed raw into self._executor.submit" in m for m in msgs) == 1


def test_guarded_by_annotation_bad_fixture_cross_checks_lock_names():
    msgs = messages(run_fixture("guarded-by-annotation", "guarded-by/bad"))
    assert len(msgs) == 2
    unknown = [m for m in msgs if "names no known lock" in m]
    assert len(unknown) == 1
    assert "fix.nosuch" in unknown[0]
    assert sum("needs a reason" in m for m in msgs) == 1


def test_inline_suppressions_cover_same_line_and_line_above():
    findings = run_fixture("lock-order", "suppression/bad.py")
    assert len(findings) == 3
    silenced = [f for f in findings if f.suppressed]
    loud = [f for f in findings if not f.suppressed]
    assert len(silenced) == 2 and len(loud) == 1
    assert all(f.suppress_reason for f in silenced)
    assert "LOUD" in loud[0].message


def test_syntax_error_becomes_parse_error_finding(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def nope(:\n", encoding="utf-8")
    project = load_project(tmp_path, paths=[bad], config=dict(DEFAULT_CONFIG), with_context=False)
    findings = run_rules(project, ["lock-order"])
    assert [f.rule for f in findings] == ["parse-error"]
    assert not findings[0].suppressed


def test_unknown_rule_id_raises():
    project = load_project(
        FIXTURES, paths=[FIXTURES / "lock-order" / "good.py"],
        config=dict(DEFAULT_CONFIG), with_context=False,
    )
    with pytest.raises(ValueError, match="unknown rule"):
        run_rules(project, ["no-such-rule"])


# ---------------------------------------------------------------------------
# the rules the port rewrites: torch-idiom fixtures
# ---------------------------------------------------------------------------

DISPATCH_BAD = """
    import torch

    from k_llms_tpu_torch.analysis.lockcheck import make_lock
    from k_llms_tpu_torch.models.llama import decode_step
    from k_llms_tpu_torch.ops.paged_attention import paged_decode_attention


    class Stepper:
        def __init__(self):
            self._guard = make_lock("fix.guard")

        def step(self, q, pool):
            with self._guard:
                return paged_decode_attention(q, pool)

        def fence(self):
            with self._guard:
                torch.cuda.synchronize()

        def forward(self, tok):
            with self._guard:
                return self._model_step(tok)

        def _model_step(self, tok):
            return decode_step(tok)
"""

DISPATCH_GOOD = """
    import torch

    from k_llms_tpu_torch.analysis.lockcheck import make_lock, make_rlock
    from k_llms_tpu_torch.ops.attention import flash_attention
    from k_llms_tpu_torch.ops.w4matmul import w4_matmul


    class Launcher:
        def __init__(self):
            self._launch = make_rlock("fix.launch", allow_dispatch=True)
            self._stats_lock = make_lock("fix.stats")
            self.launches = 0

        def prefill(self, q, k, v):
            with self._launch:
                out = flash_attention(q, k, v)
                torch.cuda.synchronize()
            with self._stats_lock:
                self.launches += 1
            return out

        def matmul(self, x, w):
            out = w4_matmul(x, w)  # no lock held
            with self._stats_lock:
                self.launches += 1
            return out
"""


def test_dispatch_under_lock_bad_fixture(tmp_path):
    msgs = messages(run_source(tmp_path, "dispatch-under-lock", "bad.py", DISPATCH_BAD))
    assert len(msgs) == 3
    assert all("fix.guard" in m and "allow_dispatch" in m for m in msgs)


def test_dispatch_under_lock_good_fixture_is_clean(tmp_path):
    assert messages(run_source(tmp_path, "dispatch-under-lock", "good.py", DISPATCH_GOOD)) == []


def test_dispatch_under_lock_ignores_the_jax_idioms():
    """The JAX fixture's callees (``*_fn``, ``jax.device_get``) are not the
    port's device work: the rewritten rule stays silent on them."""
    assert messages(run_fixture("dispatch-under-lock", "dispatch-under-lock/bad.py")) == []


HOT_CFG = {
    "host-sync-hot-path": {
        "hot_functions": [
            "decode_step", "paged_*", "grammar_mask_logits", "Engine._decode",
            "Engine._decode.sample",
        ]
    }
}

HOT_BAD = """
    import torch


    def decode_step(logits):
        tok = logits.argmax(-1)
        first = tok[0].item()
        done = bool(tok.eq(0).all())
        return first, done


    def paged_decode_attention_ref(q, table):
        ids = table.tolist()
        return q[ids]


    def grammar_mask_logits(logits, states):
        torch.cuda.synchronize()
        return logits


    class Engine:
        def _decode(self, x):
            def sample(logits):
                return int(torch.argmax(logits))

            return sample(x.cpu())

        def launch(self, x):
            return x.item()
"""

HOT_GOOD = """
    import torch


    def decode_step(logits, stats):
        tok = logits.argmax(-1)
        host = tok.to("cpu", non_blocking=True)
        width = int(stats["width"])
        return tok, host, width


    def paged_decode_attention_ref(q, table):
        return q[table]


    def grammar_mask_logits(logits, states):
        return logits.masked_fill(states[:, None] < 0, float("-inf"))


    class Engine:
        def _decode(self, x):
            def sample(logits):
                return torch.argmax(logits, dim=-1)

            return sample(x)

        def launch(self, x):
            return x.item()
"""


def test_host_sync_bad_fixture_flags_every_torch_sync(tmp_path):
    msgs = messages(run_source(tmp_path, "host-sync-hot-path", "bad.py", HOT_BAD, HOT_CFG))
    assert len(msgs) == 6
    assert all("a configured hot function" in m for m in msgs)
    assert any("*.item" in m and "decode_step" in m for m in msgs)
    assert any("bool(<tensor>)" in m for m in msgs)
    assert any("*.tolist" in m and "paged_decode_attention_ref" in m for m in msgs)
    assert any("torch.cuda.synchronize" in m for m in msgs)
    # A closure is hot by its qualified name.
    assert any("int(<tensor>)" in m and "Engine._decode.sample" in m for m in msgs)
    assert any("*.cpu" in m and "(Engine._decode)" in m for m in msgs)
    assert not any("Engine.launch" in m for m in msgs)


def test_host_sync_good_fixture_is_clean(tmp_path):
    assert messages(run_source(tmp_path, "host-sync-hot-path", "good.py", HOT_GOOD, HOT_CFG)) == []


def test_host_sync_ignores_the_jax_idioms():
    """``np.asarray`` and ``jax.device_get`` are host work for torch code
    (a CUDA tensor cannot pass through numpy): the port's rule flags only
    the JAX fixture's ``.item()``/``.tolist()``."""
    msgs = messages(
        run_fixture("host-sync-hot-path", "host-sync-hot-path/bad.py", HOT_CFG)
    )
    assert msgs and all(("*.item" in m) or ("*.tolist" in m) for m in msgs)


JIT_BAD = """
    import ctypes

    import torch


    def handle_request(model, x):
        fn = torch.compile(model)
        return fn(x)


    def per_request_graph():
        g = torch.cuda.CUDAGraph()
        return g


    def load_kernel(path):
        return ctypes.CDLL(path)
"""

JIT_GOOD = """
    import ctypes
    import functools

    import torch

    _LIBS = {}
    _lib = None
    SHARED = torch.compile(lambda x: x)


    class Runner:
        def __init__(self, model):
            self._fn = torch.compile(model)
            self._graphs = {}

        def graph(self, key):
            g = self._graphs.get(key)
            if g is None:
                g = torch.cuda.CUDAGraph()
                self._graphs[key] = g
            return g


    def load(path):
        lib = _LIBS.get(path)
        if lib is None:
            lib = ctypes.CDLL(path)
            _LIBS[path] = lib
        return lib


    def load_global(path):
        global _lib
        if _lib is None:
            _lib = ctypes.CDLL(path)
        return _lib


    @functools.lru_cache(maxsize=None)
    def compiled(model):
        return torch.compile(model)


    def _get_step_graph(key):
        return torch.cuda.CUDAGraph()
"""

JIT_CFG = {"jit-recompile-hygiene": {"builder_functions": ["_get_step_graph"]}}


def test_jit_recompile_bad_fixture(tmp_path):
    msgs = messages(run_source(tmp_path, "jit-recompile-hygiene", "bad.py", JIT_BAD))
    assert len(msgs) == 3
    assert all("recompiles on every call" in m for m in msgs)
    assert any("torch.compile" in m and "handle_request" in m for m in msgs)
    assert any("torch.cuda.CUDAGraph" in m for m in msgs)
    assert any("ctypes.CDLL" in m and "load_kernel" in m for m in msgs)


def test_jit_recompile_good_fixture_sanctions_every_memoized_pattern(tmp_path):
    assert messages(
        run_source(tmp_path, "jit-recompile-hygiene", "good.py", JIT_GOOD, JIT_CFG)
    ) == []


def test_jit_recompile_builder_config_is_load_bearing(tmp_path):
    msgs = messages(run_source(tmp_path, "jit-recompile-hygiene", "good.py", JIT_GOOD))
    assert len(msgs) == 1 and "_get_step_graph" in msgs[0]


# ---------------------------------------------------------------------------
# the port's suppressions
# ---------------------------------------------------------------------------


def test_every_suppression_in_the_port_carries_a_reason():
    findings = run_rules(load_project(REPO))
    suppressed = [f for f in findings if f.suppressed]
    assert suppressed
    for f in suppressed:
        assert len(f.suppress_reason) > 10, f.format()


def test_port_only_host_syncs_name_their_queue_item():
    """A host sync JAX does not have is suppressed as port-only, with the
    ROADMAP item that takes it off the decode path, or as a plain version
    that runs on CPU tensors only."""
    findings = run_rules(load_project(REPO), ["host-sync-hot-path"])
    port_only = [f for f in findings if f.suppress_reason.startswith("port-only")]
    assert port_only
    for f in port_only:
        reason = f.suppress_reason
        assert "ROADMAP Queue 2 item 2" in reason or "CPU tensors only" in reason, f.format()
    assert any("done.all()" in f.suppress_reason or "exit test" in f.suppress_reason
               for f in port_only)


# ---------------------------------------------------------------------------
# CLI contract + the tier-1 package gate
# ---------------------------------------------------------------------------


def _cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "k_llms_tpu_torch.analysis", *args],
        cwd=cwd, capture_output=True, text=True, timeout=120,
    )


@pytest.mark.duration_budget(20)
def test_package_is_lint_clean_via_check_cli():
    """The gate: `python -m k_llms_tpu_torch.analysis --check` exits 0 over
    the port, with the full rule set enabled."""
    proc = _cli("--check", "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert set(doc) == {"root", "files", "rules", "findings", "ok"}
    assert doc["ok"] is True
    assert doc["findings"] == []
    assert doc["files"] > 50
    assert EXPECTED_RULES <= set(doc["rules"])


def test_package_lint_in_process_matches_cli():
    project = load_project(REPO)
    assert all(f.rel.startswith("k_llms_tpu_torch/") for f in project.files)
    findings = unsuppressed(run_rules(project))
    assert not findings, "\n".join(f.format() for f in findings)


def test_cli_exits_one_with_findings_on_bad_fixture():
    proc = _cli(
        "--root", str(FIXTURES), str(FIXTURES / "lock-order" / "bad.py"),
        "--rule", "lock-order", "--json",
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["ok"] is False
    assert doc["rules"] == ["lock-order"]
    for f in doc["findings"]:
        assert set(f) == {"rule", "file", "line", "message", "suppressed", "suppress_reason"}
        assert f["rule"] == "lock-order" and f["line"] > 0


def test_cli_list_rules_and_usage_error():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    for rid in EXPECTED_RULES:
        assert rid in proc.stdout
    proc = _cli("--rule", "no-such-rule")
    assert proc.returncode == 2
    assert "unknown rule" in proc.stderr


def test_sarif_output_matches_2_1_0_shape():
    proc = _cli(
        "--root", str(FIXTURES), str(FIXTURES / "guarded-by" / "bad"),
        "--rule", "guarded-by", "--sarif",
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["version"] == "2.1.0"
    assert doc["$schema"].endswith("sarif-schema-2.1.0.json")
    (run,) = doc["runs"]
    driver = run["tool"]["driver"]
    assert driver["name"] == "kllms-check"
    assert [r["id"] for r in driver["rules"]] == ["guarded-by"]
    assert run["originalUriBaseIds"]["SRCROOT"]["uri"].startswith("file://")
    assert len(run["results"]) == 3
    for res in run["results"]:
        assert res["ruleId"] == "guarded-by" and res["ruleIndex"] == 0
        loc = res["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"].endswith(".py")
        assert loc["region"]["startLine"] >= 1
        assert res["partialFingerprints"]["kllmsFingerprint/v1"]


def test_sarif_and_json_are_mutually_exclusive():
    proc = _cli("--sarif", "--json")
    assert proc.returncode == 2
    assert "mutually exclusive" in proc.stderr


def test_baseline_makes_dirty_tree_pass_but_new_finding_fails(tmp_path):
    bad = str(FIXTURES / "guarded-by" / "bad")
    base = tmp_path / "baseline.json"
    proc = _cli("--root", str(FIXTURES), bad, "--rule", "guarded-by",
                "--write-baseline", str(base))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(base.read_text(encoding="utf-8"))
    assert doc["version"] == 1 and len(doc["fingerprints"]) == 3
    proc = _cli("--root", str(FIXTURES), bad, "--rule", "guarded-by",
                "--check", "--baseline", str(base))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = _cli("--root", str(FIXTURES), bad, "--rule", "guarded-by",
                "--rule", "guarded-by-escape", "--check", "--baseline", str(base))
    assert proc.returncode == 1
    assert "guarded-by-escape" in proc.stdout


def test_baseline_usage_error_on_malformed_file(tmp_path):
    broken = tmp_path / "broken.json"
    broken.write_text("not json", encoding="utf-8")
    proc = _cli("--baseline", str(broken))
    assert proc.returncode == 2
    assert "--baseline" in proc.stderr
