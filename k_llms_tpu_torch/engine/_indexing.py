"""Indexing with the JAX package's out-of-range rules, for the constraint
automata's device ops.

JAX never raises on an index outside an array: ``x[i]`` wraps a negative
index once and then clamps it into range, ``take_along_axis`` fills an
out-of-range position, and a scatter with repeated indices combines them.
Torch raises (or, on a card, asserts) instead, so the automata's torch ops
index through these helpers and give the JAX functions' values bit for bit,
for dead states (-1) and stray tokens alike. Nothing here reads a value back
to the host.
"""

from __future__ import annotations

import torch

#: What ``jnp.take_along_axis`` returns for an out-of-range int32 position.
INT32_FILL = -(2 ** 31)


def jax_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` as ``jnp`` indexing reads it along an axis of length ``n``:
    negatives wrap once, then everything clamps into ``[0, n)``."""
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, n - 1)


def take_last_axis(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(table, pos[:, None], axis=1)[:, 0]`` for
    non-negative ``pos``: positions past the axis read ``INT32_FILL``."""
    width = table.shape[1]
    got = table.gather(1, pos.clamp(max=width - 1)[:, None])[:, 0]
    return torch.where(pos < width, got, torch.full_like(got, INT32_FILL))


def open_eos(mask: torch.Tensor, eos_arr: torch.Tensor, eos_ok: torch.Tensor) -> torch.Tensor:
    """``mask.at[:, clip(eos_arr, 0, V - 1)].max(eos_ok[:, None] & (eos_arr >= 0))``:
    each row's EOS columns open where ``eos_ok``; entries below 0 open
    nothing. The columns are applied one after another, so a column named
    twice ends as the OR of its entries, as JAX's scatter-max leaves it."""
    V = mask.shape[1]
    cols = eos_arr.clamp(0, V - 1)
    vals = eos_ok[:, None] & (eos_arr >= 0)[None, :]
    for e in range(eos_arr.shape[0]):
        col = cols[e : e + 1]
        mask.index_copy_(1, col, mask.index_select(1, col) | vals[:, e : e + 1])
    return mask
