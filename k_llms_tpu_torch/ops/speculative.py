"""Prompt-lookup speculative decoding: draft proposal, acceptance and the
per-row scatters of the verify loop.

Counterpart of ``k_llms_tpu/ops/speculative.py``, on tensors, with the same
shapes and dtypes. Extraction outputs copy long spans of the prompt (field
values, names, numbers): the drafter matches the row's trailing token bigram
in its prompt (or in its own generated text) and proposes the k tokens that
followed it there; ``models.llama.verify_step`` scores the row's last token
and its k drafts in one forward, and :func:`accept_drafts` decides how many
of the k + 1 per-position draws can be emitted.

Acceptance is sample-and-match: position j's token is drawn from the model's
own conditional given the drafts before it, so every emitted token is an
exact sample of the autoregressive chain at any temperature, and greedy
decoding reproduces normal decode token for token.

The JAX package has no kernel for these functions (they are XLA ops there),
and a verify iteration is dominated by the forward's layers, so they stay
plain torch ops on whatever device their tensors live on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _last_match(rows: torch.Tensor, prev: torch.Tensor, cur: torch.Tensor,
                limit: torch.Tensor) -> torch.Tensor:
    """[B] index of the LAST position p in 1..S-1 with ``rows[b, p-1] ==
    prev[b]``, ``rows[b, p] == cur[b]`` and ``p < limit[b]``, or -1."""
    S = rows.shape[1]
    pos = torch.arange(1, S, device=rows.device)
    hit = (rows[:, :-1] == prev[:, None]) & (rows[:, 1:] == cur[:, None]) & (
        pos[None, :] < limit[:, None]
    )
    return torch.where(hit, pos[None, :], torch.full_like(pos, -1)[None, :]).amax(dim=1)


def _continuation(rows: torch.Tensor, last: torch.Tensor, length: torch.Tensor,
                  cur: torch.Tensor, k: int) -> torch.Tensor:
    """The k tokens after position ``last`` of each row, those at or past
    ``length`` (or every one, without a match) replaced by ``cur``. [B, k]
    int32."""
    S = rows.shape[1]
    idx = last[:, None] + 1 + torch.arange(k, device=rows.device)[None, :]
    ok = (last[:, None] >= 0) & (idx < length[:, None])
    picked = torch.gather(rows, 1, idx.clamp(0, S - 1))
    return torch.where(ok, picked, cur[:, None].to(rows.dtype)).to(torch.int32)


def propose_prompt_lookup(
    prompt: torch.Tensor,
    prompt_len,
    prev: torch.Tensor,
    cur: torch.Tensor,
    k: int,
    gen: Optional[torch.Tensor] = None,
    gen_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-row drafts from the prompt and (optionally) the row's own
    generated text. ``prompt``: [S] token buffer shared by all rows, or
    [B, S] per-row buffers (coalesced batches: each request's rows search
    their own prompt); ``prompt_len``: a scalar valid length, or [B]
    per-row lengths with a 2-D prompt; ``prev``/``cur``: [B] the row's
    trailing bigram; ``gen``: [B, T] generated-token buffers with valid
    lengths ``gen_len`` [B].

    Returns drafts [B, k] int32: the k tokens following the LAST occurrence
    of (prev, cur), preferring a match in the row's generated text over one
    in the prompt. Rows without a match, and draft positions past the
    source's end, repeat ``cur``."""
    B = prev.shape[0]
    device = prev.device
    prev = prev.to(torch.int64)
    cur = cur.to(torch.int64)
    rows = prompt.to(torch.int64)
    if rows.dim() == 1:
        rows = rows[None, :].expand(B, rows.shape[0])
    plen = torch.as_tensor(prompt_len, device=device).to(torch.int64).reshape(-1).expand(B)
    drafts = _continuation(rows, _last_match(rows, prev, cur, plen), plen, cur, k)
    if gen is None:
        return drafts
    gen = gen.to(torch.int64)
    glen = gen_len.to(device=device, dtype=torch.int64)
    # The row's TRAILING bigram (position glen - 1) is excluded: matching it
    # is vacuous and its continuation lies past the generated text.
    glast = _last_match(gen, prev, cur, glen - 1)
    gen_drafts = _continuation(gen, glast, glen, cur, k)
    return torch.where((glast >= 0)[:, None], gen_drafts, drafts)


def accept_drafts(
    sampled: torch.Tensor,
    drafts: torch.Tensor,
    eos_ids: torch.Tensor,
    budget: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decide how many of the k + 1 per-position draws can be emitted.

    ``sampled``: [B, k+1], position j's token drawn from p(. | prefix,
    drafts[:j]); ``drafts``: [B, k]; ``eos_ids``: [MAX_EOS] (-1 padded);
    ``budget``: [B] tokens the row may still emit. Position j+1's draw is
    valid only if every earlier draw matched its draft; emission also stops
    after the first emitted eos and at the budget. Returns (emit [B, k+1]
    bool, counts [B] int32, hit_eos [B] bool)."""
    B, k1 = sampled.shape
    k = k1 - 1
    matched = sampled[:, :k] == drafts
    chain = torch.cumprod(matched.to(torch.int32), dim=1)
    valid = torch.cat(
        [torch.ones((B, 1), dtype=torch.int32, device=sampled.device), chain], dim=1
    ).bool()
    is_eos = torch.isin(sampled, eos_ids)
    eos_before = torch.cumsum((valid & is_eos).to(torch.int32), dim=1)
    no_eos_before = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int32, device=sampled.device), eos_before[:, :-1]],
        dim=1,
    ) == 0
    within_budget = torch.arange(k1, device=sampled.device)[None, :] < budget[:, None]
    emit = valid & no_eos_before & within_budget
    counts = emit.sum(dim=1).to(torch.int32)
    hit_eos = (emit & is_eos).any(dim=1)
    return emit, counts, hit_eos


def _check_fits(name: str, T: int, W: int, max_offset: int) -> None:
    if max_offset + W > T:
        raise ValueError(
            f"{name}: a write of {W} at offset up to {max_offset} overruns the buffer's "
            f"{T} positions (JAX's dynamic_update_slice would clamp it; the engine sizes "
            "its buffers so that it never has to)"
        )


def scatter_rows(buf: torch.Tensor, values: torch.Tensor, offsets: torch.Tensor,
                 max_offset: int) -> torch.Tensor:
    """Write ``values`` [B, W] into ``buf`` [B, T] at per-row ``offsets``
    [B], in place; returns ``buf``. ``max_offset`` is the caller's host
    bound on every offset: JAX's ``dynamic_update_slice`` clamps a start
    past ``T - W``, torch indexing does not, so a bound that could need the
    clamp raises ``ValueError`` (no device sync: the bound is the caller's
    invariant, such as the spec loop's ``count <= max_new`` against a
    buffer of ``max_new + K + 1``)."""
    B, W = values.shape
    _check_fits("scatter_rows", buf.shape[1], W, int(max_offset))
    idx = offsets.to(torch.int64)[:, None] + torch.arange(W, device=buf.device)[None, :]
    buf.scatter_(1, idx, values.to(buf.dtype))
    return buf


def scatter_rows_k(buf: torch.Tensor, values: torch.Tensor, offsets: torch.Tensor,
                   max_offset: int) -> torch.Tensor:
    """:func:`scatter_rows` for per-position top-k payloads: ``buf`` [B, T,
    K], ``values`` [B, W, K], the trailing axis riding along."""
    B, W, KT = values.shape
    _check_fits("scatter_rows_k", buf.shape[1], W, int(max_offset))
    idx = offsets.to(torch.int64)[:, None] + torch.arange(W, device=buf.device)[None, :]
    buf.scatter_(1, idx[:, :, None].expand(B, W, KT), values.to(buf.dtype))
    return buf
