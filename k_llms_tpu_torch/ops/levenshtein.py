"""Batched exact Levenshtein distances: the hand-written kernel's wrapper and
its plain version.

Counterpart of the JAX package's jitted row scan
(``k_llms_tpu/consensus/device.py``, ``_lev_kernel``): ``a``, ``b`` [P, L]
int32 byte codes, zero-padded past ``alen``, ``blen`` [P] int32, give [P]
int32 distances. The plain version is that scan in torch, the DP row of all
P pairs carried column by column of ``b``, the insertion chain solved as the
min-plus prefix ``cummin(d - idx) + idx``. The kernel (``csrc/levenshtein.cu``)
gives the same integers.
"""

from __future__ import annotations

import ctypes

import torch

from . import _ext

#: Longest string (codes per pair) the kernel takes.
MAX_LEN = 128


def levenshtein_plain(a: torch.Tensor, alen: torch.Tensor, b: torch.Tensor,
                      blen: torch.Tensor) -> torch.Tensor:
    """The reference's row scan: [P] int32 distances of ``a[p, :alen[p]]``
    and ``b[p, :blen[p]]``."""
    P, L = a.shape
    device = a.device
    idx = torch.arange(L + 1, dtype=torch.int32, device=device)
    row = idx.expand(P, L + 1).clone()
    res = alen.to(torch.int32).clone()
    gather_at = alen.long()[:, None]
    for j in range(L):
        sub = row[:, :-1] + (a != b[:, j:j + 1]).to(torch.int32)
        dele = row[:, 1:] + 1
        d = torch.cat(
            [torch.full((P, 1), j + 1, dtype=torch.int32, device=device), torch.minimum(sub, dele)],
            dim=1,
        )
        row = torch.cummin(d - idx, dim=1).values + idx
        got = torch.gather(row, 1, gather_at)[:, 0]
        res = torch.where(blen == j + 1, got, res)
    return res


def levenshtein(a: torch.Tensor, alen: torch.Tensor, b: torch.Tensor,
                blen: torch.Tensor) -> torch.Tensor:
    """[P] int32 distances, as :func:`levenshtein_plain`. On CUDA tensors
    this launches the kernel (or raises); on CPU tensors it runs the plain
    version."""
    if a.device.type == "cpu":
        return levenshtein_plain(a, alen, b, blen)
    if a.device.type != "cuda":
        raise ValueError(f"levenshtein: unsupported device {a.device}")
    P, L = a.shape
    if (
        a.dim() != 2 or b.shape != a.shape or alen.shape != (P,) or blen.shape != (P,)
        or not 0 < L <= MAX_LEN or P == 0
    ):
        raise ValueError(
            f"levenshtein: bad shapes a={tuple(a.shape)} b={tuple(b.shape)} "
            f"alen={tuple(alen.shape)} blen={tuple(blen.shape)} (L <= {MAX_LEN})"
        )
    args = []
    for name, t in (("a", a), ("alen", alen), ("b", b), ("blen", blen)):
        if t.device != a.device or t.dtype != torch.int32:
            raise ValueError(f"levenshtein: {name} must be int32 on {a.device}")
        args.append(t.contiguous())
    out = torch.empty((P,), dtype=torch.int32, device=a.device)
    lib = _ext.load("levenshtein")
    status = lib.kllms_levenshtein(
        args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(), args[3].data_ptr(),
        out.data_ptr(), P, L,
        ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream),
    )
    _ext.check_status("levenshtein", status)
    _ext.note_launch("levenshtein")
    return out
