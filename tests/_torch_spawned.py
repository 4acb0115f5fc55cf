"""Running ``tests/_torch_spawned_script.py`` from a test: a plain process
that starts its host's followers itself."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_spawned_script.py")


def script_env():
    """The test process's environment without pytest's, a rank's or an
    armed failpoint's variables (the script sets its own rank count)."""
    drop = ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "KLLMS_LOCAL_RANKS", "KLLMS_COORDINATOR",
            "KLLMS_NUM_PROCESSES", "KLLMS_PROCESS_ID")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST") and k not in drop}
    env["KLLMS_FAILPOINTS"] = ""
    return env


def start(case, **kwargs) -> subprocess.Popen:
    """The script's ``case_<case>(**kwargs)`` in a process of its own; its
    standard error (the followers' output with it) goes to a temporary file,
    so no pipe fills while the test waits."""
    log = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, SCRIPT, case, json.dumps(kwargs)],
                            env=script_env(), stdout=subprocess.PIPE, stderr=log, text=True)
    proc.log = log
    return proc


def result(proc: subprocess.Popen, timeout: float = 120.0) -> dict:
    """The script's RESULT, once it has exited 0."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    proc.log.seek(0)
    err = proc.log.read()
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, f"exit {proc.returncode}\n{out}\n{err[-6000:]}"
    return json.loads(lines[-1][len("RESULT "):])
