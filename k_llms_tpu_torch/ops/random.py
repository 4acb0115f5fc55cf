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

The plain version holds uint32 words in int64 tensors, masked to 32 bits
after every add and shift (torch has no uint32 arithmetic on every device).
The kernel, ``csrc/threefry.cu``, computes the same bits in native
``uint32_t``; the float conversion is exact integer work and one multiply-add
whose product ``f * 1.0f`` is exact, so the kernel's uniforms equal these bit
for bit.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

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


def threefry_uniform_plain(req_keys: torch.Tensor, step: torch.Tensor, n_per: int,
                           V: int) -> torch.Tensor:
    """``[R * n_per, V]`` float32 uniforms of one decode step: row
    ``j * n_per + i`` is ``uniform_tiny(fold_in(fold_in(req_keys[j], step), i), V)``."""
    return uniform_tiny(row_keys(req_keys, step, n_per), V)


def threefry_uniform(req_keys: torch.Tensor, step: torch.Tensor, n_per: int,
                     V: int) -> torch.Tensor:
    """One decode step's uniforms for every row, as
    :func:`threefry_uniform_plain`. ``req_keys`` [R, 2] int64 key words,
    ``step`` a 0-d integer tensor on the same device (a device scalar, so the
    call needs no host value and replays in a CUDA graph). On a CUDA tensor
    this launches the kernel; on a CPU tensor it runs the plain version."""
    if req_keys.device.type != "cuda":
        return threefry_uniform_plain(req_keys, step, n_per, V)
    if req_keys.dim() != 2 or req_keys.shape[1] != 2 or req_keys.dtype != torch.int64:
        raise ValueError(f"threefry_uniform: req_keys must be [R, 2] int64, got "
                         f"{tuple(req_keys.shape)} {req_keys.dtype}")
    if step.numel() != 1 or step.dtype != torch.int32 or step.device != req_keys.device:
        raise ValueError("threefry_uniform: step must be one int32 on the keys' device")
    if n_per < 1 or V < 1:
        raise ValueError(f"threefry_uniform: n_per={n_per}, V={V}")
    R = req_keys.shape[0]
    keys = req_keys.contiguous()
    out = torch.empty((R * n_per, V), dtype=torch.float32, device=req_keys.device)
    lib = _ext.load("threefry")
    status = lib.kllms_threefry_uniform(
        keys.data_ptr(), step.data_ptr(), out.data_ptr(), R, n_per, V,
        ctypes.c_void_p(torch.cuda.current_stream(req_keys.device).cuda_stream),
    )
    _ext.check_status("threefry_uniform", status)
    _ext.note_launch("threefry_uniform")
    return out
