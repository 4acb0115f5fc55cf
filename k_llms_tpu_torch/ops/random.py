"""Seeded draws equal to the JAX package's: threefry2x32 and the uniform
conversion of ``jax.random``, in torch integer ops (the plain version), and
the wrapper of the hand-written kernel that draws a decode step's uniforms.

The JAX engine samples row i of a request at decode step s with the key
``fold_in(fold_in(key(seed), s), i)`` through ``jax.random.categorical``,
which takes ``argmax(logits - log(-log(u)))`` over uniforms
``u = jax.random.uniform(key, (V,), minval=tiny, maxval=1)``. With
``jax_threefry_partitionable`` set (the JAX package's configuration):

- ``key(seed)`` holds the words ``[0, seed mod 2**32]``;
- ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
- the 32 random bits of column c are ``y0 ^ y1`` of ``threefry2x32(k, (0, c))``;
- ``u = max(tiny, f * (1 - tiny) + tiny)`` with
  ``f = bitcast_f32((bits >> 9) | 0x3F800000) - 1``.

The continuous decode loop keys each row on its own: row ``r`` at loop step
``s_r`` with sample index ``i_r`` takes ``fold_in(fold_in(key(seed_r), s_r), i_r)``.
:func:`threefry_uniform_rows` draws with a key, step and index per row, one
launch per step; a coalesced step (:func:`threefry_uniform`) is the case of
one key per request, one step and the index of the row within its request,
and a speculative verify iteration (:func:`threefry_uniform_verify`) the
case of the request's key folded with the iteration, the draft position as
the step and the row within its request as the index.

The plain version holds uint32 words in int64 tensors, masked to 32 bits
after every add and shift (torch has no uint32 arithmetic on every device).
The kernel, ``csrc/threefry.cu``, computes the same bits in native
``uint32_t``; the float conversion is exact integer work and one multiply-add
whose product ``f * 1.0f`` is exact, so the kernel's uniforms equal these bit
for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _ext

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)
# jax.random.uniform's scale, maxval - minval in float32: it rounds to 1.0.
_SCALE = float(np.float32(1.0) - np.float32(_TINY))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 words held in int64 tensors
    (broadcast together). Returns the two output words."""
    k0 = torch.as_tensor(k0, dtype=torch.int64) & M32
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=k0.device) & M32
    x0 = torch.as_tensor(x0, dtype=torch.int64, device=k0.device) & M32
    x1 = torch.as_tensor(x1, dtype=torch.int64, device=k0.device) & M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & M32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & M32
    return x0, x1


def key_data(seed: int) -> torch.Tensor:
    """The words of ``jax.random.key(seed)``: ``[0, seed mod 2**32]`` (int64)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` on key words ``[..., 2]`` and uint32 ``data``
    (broadcast against the key's batch shape)."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def row_keys(req_keys: torch.Tensor, step, n_per: int) -> torch.Tensor:
    """Key words of every decode row, ``[R * n_per, 2]``, request-major:
    row ``j * n_per + i`` takes ``fold_in(fold_in(req_keys[j], step), i)``."""
    step_keys = fold_in(req_keys, torch.as_tensor(step, device=req_keys.device))
    rows = torch.arange(n_per, dtype=torch.int64, device=req_keys.device)
    return fold_in(step_keys[:, None, :], rows[None, :]).reshape(-1, 2)


def random_bits(key: torch.Tensor, V: int) -> torch.Tensor:
    """``jax.random.bits(key, (V,))`` for key words ``[..., 2]``: ``[..., V]``
    uint32 words in int64."""
    cols = torch.arange(V, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, cols)
    return y0 ^ y1


def uniform_tiny(key: torch.Tensor, V: int) -> torch.Tensor:
    """``jax.random.uniform(key, (V,), minval=tiny, maxval=1.)`` in float32,
    bit for bit, for key words ``[..., 2]``."""
    bits = random_bits(key, V)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * _SCALE + _TINY, _TINY)


def request_keys(seeds: Sequence[int], device) -> torch.Tensor:
    """``[R, 2]`` int64 key words of ``jax.random.key(s)`` for each seed."""
    return torch.stack([key_data(s) for s in seeds]).to(device)


def threefry_uniform(req_keys: torch.Tensor, step: torch.Tensor, n_per: int,
                     V: int, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One decode step's uniforms for the rows of a coalesced launch,
    ``[R * n_per, V]`` float32, request-major: row ``j * n_per + i`` is
    ``uniform_tiny(fold_in(fold_in(req_keys[j], step), i), V)``. The per-row
    draw (:func:`threefry_uniform_rows`) with each request's key repeated
    ``n_per`` times, the step shared and the index the row within its
    request. ``req_keys`` [R, 2] int64 key words, ``step`` one int32 on the
    same device (a device scalar, so the call needs no host value and
    replays in a CUDA graph). ``rows`` ``(lo, hi)`` draws only the launch's
    rows [lo, hi) (a data rank's share), the same bits as those rows of the
    whole draw."""
    if req_keys.dim() != 2 or req_keys.shape[1] != 2 or n_per < 1:
        raise ValueError(f"threefry_uniform: req_keys must be [R, 2], got "
                         f"{tuple(req_keys.shape)}; n_per={n_per}")
    R = req_keys.shape[0]
    lo, hi = rows if rows is not None else (0, R * n_per)
    if not 0 <= lo < hi <= R * n_per:
        raise ValueError(f"threefry_uniform: rows {rows} outside the launch's {R * n_per}")
    g = torch.arange(lo, hi, device=req_keys.device)
    keys = req_keys[g // n_per]
    steps = step.reshape(1).expand(hi - lo)
    index = (g % n_per).to(torch.int32)
    return threefry_uniform_rows(keys, steps, index, V)


def threefry_uniform_verify(req_keys: torch.Tensor, iteration: torch.Tensor, n_per: int,
                            positions: int, V: int,
                            rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One speculative verify iteration's uniforms, ``[R * n_per * positions,
    V]`` float32, laid out row-major ``(row, position)`` as the flattened
    verify logits are: position j of sample i of request r takes
    ``uniform_tiny(fold_in(fold_in(fold_in(req_keys[r], iteration), j), i),
    V)``, the JAX spec loop's keys. The per-row draw
    (:func:`threefry_uniform_rows`) with keys ``fold_in(req_keys[r],
    iteration)``, step j and index i: one launch an iteration.
    ``iteration`` is a 0-d int32 tensor on the keys' device, so no host
    value enters the draw. ``rows`` ``(lo, hi)`` draws only the launch's
    rows [lo, hi) (a data rank's share), keyed by each row's global request
    and index: the same bits as those rows of the whole draw."""
    if req_keys.dim() != 2 or req_keys.shape[1] != 2 or n_per < 1 or positions < 1:
        raise ValueError(f"threefry_uniform_verify: req_keys must be [R, 2], got "
                         f"{tuple(req_keys.shape)}; n_per={n_per}, positions={positions}")
    R = req_keys.shape[0]
    lo, hi = rows if rows is not None else (0, R * n_per)
    if not 0 <= lo < hi <= R * n_per:
        raise ValueError(f"threefry_uniform_verify: rows {rows} outside the launch's {R * n_per}")
    device = req_keys.device
    # fold_in with the iteration's words already on the device: no host
    # value is copied in, so the call can be captured in a CUDA graph.
    it = iteration.to(torch.int64).reshape(1).expand(R)
    y0, y1 = threefry2x32(req_keys[:, 0], req_keys[:, 1], torch.zeros_like(it), it)
    it_keys = torch.stack([y0, y1], dim=-1)  # [R, 2]
    g = torch.arange(lo, hi, device=device)
    keys = it_keys[g // n_per].repeat_interleave(positions, dim=0)
    steps = torch.arange(positions, dtype=torch.int32, device=device).repeat(hi - lo)
    index = (g % n_per).to(torch.int32).repeat_interleave(positions)
    return threefry_uniform_rows(keys, steps, index, V)


def threefry_uniform_rows_plain(keys: torch.Tensor, steps: torch.Tensor, index: torch.Tensor,
                                V: int) -> torch.Tensor:
    """``[B, V]`` float32 uniforms with a key, step and sample index per row:
    row ``r`` is ``uniform_tiny(fold_in(fold_in(keys[r], steps[r]), index[r]), V)``
    (the continuous loop's row keys)."""
    k = fold_in(keys, steps.to(torch.int64))
    return uniform_tiny(fold_in(k, index.to(torch.int64)), V)


def threefry_uniform_rows(keys: torch.Tensor, steps: torch.Tensor, index: torch.Tensor,
                          V: int) -> torch.Tensor:
    """One decode step's uniforms, as :func:`threefry_uniform_rows_plain`.
    ``keys`` [B, 2] int64 key words (:func:`request_keys` of each row's
    seed), ``steps`` and ``index`` [B] int32 on the same device. On a CUDA
    tensor this launches the kernel; on a CPU tensor it runs the plain
    version."""
    if keys.device.type != "cuda":
        return threefry_uniform_rows_plain(keys, steps, index, V)
    B = keys.shape[0]
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"threefry_uniform_rows: keys must be [B, 2] int64, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    for name, t in (("steps", steps), ("index", index)):
        if t.shape != (B,) or t.dtype != torch.int32 or t.device != keys.device:
            raise ValueError(f"threefry_uniform_rows: {name} must be [B] int32 on the keys' device")
    if B < 1 or V < 1:
        raise ValueError(f"threefry_uniform_rows: B={B}, V={V}")
    # Held until the launch: a copy freed after its data_ptr() is read can
    # hand its block to the next copy before the kernel reads it.
    keys, steps, index = keys.contiguous(), steps.contiguous(), index.contiguous()
    out = torch.empty((B, V), dtype=torch.float32, device=keys.device)
    lib = _ext.load("threefry")
    status = lib.kllms_threefry_uniform_rows(
        keys.data_ptr(), steps.data_ptr(), index.data_ptr(), out.data_ptr(), B, V,
        ctypes.c_void_p(torch.cuda.current_stream(keys.device).cuda_stream),
    )
    _ext.check_status("threefry_uniform_rows", status)
    _ext.note_launch("threefry_uniform_rows")
    return out
