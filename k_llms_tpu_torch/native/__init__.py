"""ctypes bindings for the native C++ scalar kernels.

The reference leans on two native wheels for its scalar hot loops: the
python-Levenshtein C extension and scipy's Hungarian solver
(`k_llms/utils/consensus_utils.py:15,20,372,759`). Here both are
first-party C++ (``levenshtein.cpp``, ``hungarian.cpp``) compiled to one shared
library and bound via ctypes — no pybind11 dependency. Pure-Python fallbacks keep
the package importable before the library is built; ``build()`` compiles it with
the host C++ compiler on demand (and is attempted once, silently, at import).

These stay host-side on purpose: inputs are tiny (n <= 32 samples, short strings),
so the TPU/MXU has no role here — see SURVEY.md §2.3.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [os.path.join(_DIR, "levenshtein.cpp"), os.path.join(_DIR, "hungarian.cpp")]
# Built at first use into the package's ignored build directory, never
# beside the sources.
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libkllms_native.so")

_lib: Optional[ctypes.CDLL] = None


def build(quiet: bool = True) -> bool:
    """Compile the shared library into the build directory. Returns True on
    success."""
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",
             "-shared", "-o", tmp, *_SOURCES],
            check=True,
            capture_output=quiet,
            timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        if not build(quiet=True):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.kllms_levenshtein.restype = ctypes.c_int64
    lib.kllms_levenshtein.argtypes = [
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64,
    ]
    lib.kllms_linear_sum_assignment.restype = ctypes.c_int
    lib.kllms_linear_sum_assignment.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _to_u32(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)


def levenshtein_distance(s1: str, s2: str) -> int:
    """Edit distance between two strings (code-point level)."""
    lib = _load()
    if lib is not None:
        a = _to_u32(s1)
        b = _to_u32(s2)
        ap = a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)) if a.size else ctypes.POINTER(ctypes.c_uint32)()
        bp = b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)) if b.size else ctypes.POINTER(ctypes.c_uint32)()
        return int(lib.kllms_levenshtein(ap, a.size, bp, b.size))
    return _levenshtein_py(s1, s2)


def _levenshtein_py(s1: str, s2: str) -> int:
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    if not s2:
        return len(s1)
    prev = list(range(len(s2) + 1))
    for i, ca in enumerate(s1, 1):
        cur = [i]
        for j, cb in enumerate(s2, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def linear_sum_assignment(cost: Sequence[Sequence[float]] | np.ndarray):
    """Minimum-cost assignment; same contract as scipy.optimize.linear_sum_assignment."""
    c = np.ascontiguousarray(cost, dtype=np.float64)
    if c.ndim != 2:
        raise ValueError("cost matrix must be 2-D")
    nr, nc = c.shape
    k = min(nr, nc)
    if k == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    lib = _load()
    if lib is not None and np.isfinite(c).all():
        row = np.empty(k, dtype=np.int64)
        col = np.empty(k, dtype=np.int64)
        rc = lib.kllms_linear_sum_assignment(
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nr,
            nc,
            row.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            col.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc == 0:
            return row, col
    try:  # scipy fallback (also handles +inf entries)
        from scipy.optimize import linear_sum_assignment as _scipy_lsa  # type: ignore

        return _scipy_lsa(c)
    except ImportError:
        return _lsa_py(c)


def _lsa_py(c: np.ndarray):
    """Brute-ish pure-Python augmenting-path LSAP fallback."""
    nr, nc = c.shape
    transposed = nr > nc
    if transposed:
        c = c.T
        nr, nc = c.shape
    INF = float("inf")
    u = [0.0] * (nr + 1)
    v = [0.0] * (nc + 1)
    p = [0] * (nc + 1)  # p[j] = row assigned to col j (1-indexed)
    way = [0] * (nc + 1)
    for i in range(1, nr + 1):
        p[0] = i
        j0 = 0
        minv = [INF] * (nc + 1)
        used = [False] * (nc + 1)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = -1
            for j in range(1, nc + 1):
                if used[j]:
                    continue
                cur = c[i0 - 1][j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(nc + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    pairs = sorted((p[j] - 1, j - 1) for j in range(1, nc + 1) if p[j] != 0)
    row = np.array([r for r, _ in pairs], dtype=np.int64)
    col = np.array([j for _, j in pairs], dtype=np.int64)
    if transposed:
        order = np.argsort(col, kind="stable")
        return col[order], row[order]
    return row, col


# Try to have the native library ready; harmless if the toolchain is absent.
_load()
