"""Running ``tests/_torch_hosts_script.py`` from a test: one process a
host, each with JAX's three ``KLLMS_*`` variables on a loopback coordinator
and ``KLLMS_LOCAL_RANKS`` ranks."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

from _torch_spawned import result, script_env

SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_hosts_script.py")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_hosts(case, processes=2, local_ranks=2, **kwargs):
    """``case_<case>(**kwargs)`` on ``processes`` host processes of
    ``local_ranks`` ranks each; their standard error goes to temporary
    files."""
    port = free_port()
    procs = []
    for pid in range(processes):
        env = script_env()
        env.update(KLLMS_COORDINATOR=f"127.0.0.1:{port}", KLLMS_NUM_PROCESSES=str(processes),
                   KLLMS_PROCESS_ID=str(pid), KLLMS_LOCAL_RANKS=str(local_ranks))
        log = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen([sys.executable, SCRIPT, case, json.dumps(kwargs)], env=env,
                                stdout=subprocess.PIPE, stderr=log, text=True)
        proc.log = log
        procs.append(proc)
    return procs


def results(procs, timeout=150.0):
    """Every host's RESULT, once all have exited 0 (the others are killed
    when one fails)."""
    try:
        return [result(p, timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
