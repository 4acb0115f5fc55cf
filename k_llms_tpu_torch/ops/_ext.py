"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under the package's ignored
``_build/`` directory, at first use, then loaded with ``ctypes``. Libraries are
named by a hash of their source, every shared ``csrc/*.cuh`` header and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. :func:`build_all` starts one ``nvcc`` per source, all together.

Every kernel wrapper adds one to :data:`LAUNCH_COUNTS` where it launches its
kernel and nowhere else, so a run can show that it went through the kernels.
There is no fallback: a failed build raises.

Kernels that split a reduction over CTAs and let the last CTA of each tile
finish it count arrivals in :func:`semaphores`: one int32 array per device,
zero between launches (each tile's last CTA sets its counter back to 0).
Launches that use it run in stream order; the port drives one stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: kernel library -> (source file, {C symbol: argtypes})
KERNELS = {
    "flash_attention": (
        "flash_attention.cu",
        {"kllms_flash_attention": [_P] * 5 + [_I] * 8 + [_F, _I, _F, _I, _I, _P]},
    ),
    "paged_decode": (
        "paged_decode.cu",
        {"kllms_paged_decode_attention": [_P] * 13 + [_I] * 13 + [_F, _P]},
    ),
    "decode_prefix": (
        "decode_prefix.cu",
        {"kllms_decode_prefix_attention": [_P] * 9 + [_I] * 10 + [_F, _P]},
    ),
    "w4_matmul": (
        "w4_matmul.cu",
        {"kllms_w4_matmul": [_P] * 6 + [_I] * 6 + [_P]},
    ),
    "threefry": (
        "threefry.cu",
        {"kllms_threefry_uniform_rows": [_P] * 4 + [_I] * 2 + [_P]},
    ),
    "levenshtein": (
        "levenshtein.cu",
        {"kllms_levenshtein": [_P] * 5 + [_I] * 2 + [_P]},
    ),
}

#: Launches per kernel wrapper since the last :func:`reset_launch_counts`.
LAUNCH_COUNTS: Dict[str, int] = {
    "flash_attention": 0,
    "paged_decode_attention": 0,
    "decode_prefix_attention": 0,
    "w4_matmul": 0,
    "threefry_uniform_rows": 0,
    "levenshtein": 0,
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_semaphores: Dict[str, "torch.Tensor"] = {}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def note_launch(name: str) -> None:
    LAUNCH_COUNTS[name] += 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): the CUDA "
        "kernels of k_llms_tpu_torch are built on the machine with the card"
    )


def library_path(name: str) -> str:
    """The library's path, named by a hash of its source, every header in
    ``csrc/`` (any source may include them) and the compiler flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [KERNELS[name][0], *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libkllms_{name}_{h.hexdigest()[:16]}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build the named kernel libraries (default: all) that are not built
    yet, one ``nvcc`` process per source, started together. Returns the
    seconds each build took (0.0 for a library that was already there).
    Raises RuntimeError carrying the compiler's output when one fails."""
    names = list(KERNELS if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, KERNELS[name][0])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp, out, time.perf_counter(),
        )
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The bound kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = ctypes.CDLL(path)
            for symbol, argtypes in KERNELS[name][1].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def semaphores(device, n: int):
    """An int32 array of at least ``n`` zeros on ``device``, kept for the
    process: the kernels that count arrivals in it leave it zero again."""
    import torch

    key = str(device)
    with _lock:
        sem = _semaphores.get(key)
        if sem is None or sem.numel() < n:
            sem = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
            _semaphores[key] = sem
        return sem


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} launch failed with status {status}")
