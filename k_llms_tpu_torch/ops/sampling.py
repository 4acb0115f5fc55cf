"""Token sampling with logprob capture.

Counterpart of ``k_llms_tpu/ops/sampling.py``: non-finite rows sanitised to a
uniform distribution, an optional penalty subtracted before temperature,
top-k, then top-p by the same bisection on the logit threshold (so the kept
set is the JAX function's set), then a draw. Logprobs are reported under the
untempered, unpenalised model distribution.

The draw is Gumbel-max on uniform noise from ``torch.Generator``s: one
generator per request, on the logits' device, seeded from the request's
seed. The caller draws each request's noise in a fixed order every step, so
a request's samples depend on its own seed and not on what it was batched
with. The JAX package draws with ``jax.random`` keys, whose bits torch does
not reproduce: sampled tokens agree with it at temperature 0 only.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

# Bisection steps between two host checks of the top-p loop condition. Steps
# after the condition has failed change nothing (they are masked on device),
# so checking every few steps changes only the number of host syncs.
_BISECT_CHUNK = 16


def sanitize_logits(logits: torch.Tensor) -> torch.Tensor:
    """Non-finite entries -> -inf; a row with no finite entry -> all zeros
    (uniform)."""
    finite = torch.isfinite(logits)
    row_ok = finite.any(dim=-1, keepdim=True)
    logits = torch.where(finite, logits, torch.full_like(logits, -float("inf")))
    return torch.where(row_ok, logits, torch.zeros_like(logits))


def filter_logits(
    sampling_logits: torch.Tensor, top_p: Optional[float], top_k: Optional[int]
) -> torch.Tensor:
    """Apply top-k, then top-p, to tempered logits [B, V]: dropped entries
    become -inf. Top-k keeps every entry >= the k-th largest; top-p keeps the
    smallest upper set of values whose probability mass reaches ``top_p``
    (the boundary value and its ties stay in), found by bisection on the
    threshold until each row's bracket has collapsed to adjacent floats."""
    B, V = sampling_logits.shape
    neg_inf = torch.full_like(sampling_logits, -float("inf"))
    if top_k is not None and top_k < V:
        kth = torch.topk(sampling_logits, top_k, dim=-1).values[:, -1:]
        sampling_logits = torch.where(sampling_logits < kth, neg_inf, sampling_logits)
    if top_p is not None and top_p < 1.0:
        probs = torch.softmax(sampling_logits, dim=-1)
        finite = torch.isfinite(sampling_logits)
        inf = torch.full_like(sampling_logits, float("inf"))
        lo = torch.where(finite, sampling_logits, inf).amin(dim=-1) - 1.0
        hi = torch.where(finite, sampling_logits, neg_inf).amax(dim=-1)
        # The JAX loop runs while any row's midpoint lies strictly inside its
        # bracket; a step taken here only while that holds (a device-side
        # flag) reproduces it exactly without a host sync per step.
        active = torch.ones((), dtype=torch.bool, device=lo.device)
        while bool(active):
            for _ in range(_BISECT_CHUNK):
                mid = 0.5 * (lo + hi)
                active = ((mid > lo) & (mid < hi)).any()
                mass = torch.where(
                    sampling_logits > mid[:, None], probs, torch.zeros_like(probs)
                ).sum(dim=-1)
                go_hi = mass < top_p
                lo = torch.where(active & ~go_hi, mid, lo)
                hi = torch.where(active & go_hi, mid, hi)
        threshold = torch.where(
            sampling_logits > lo[:, None], sampling_logits, inf
        ).amin(dim=-1, keepdim=True)
        sampling_logits = torch.where(sampling_logits < threshold, neg_inf, sampling_logits)
    return sampling_logits


def sample_logits(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_p: Optional[float] = None,
    top_k: Optional[int] = None,
    noise: Optional[torch.Tensor] = None,
    penalty: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample next tokens. logits: [B, V] f32. ``noise``: [B, V] uniforms in
    [0, 1) (see :func:`draw_noise`), required when ``temperature > 0``.
    ``penalty`` [B, V] is subtracted from the logits before temperature.

    Returns (tokens [B] int64, logprobs [B] f32 — log p(token) under the
    untempered model distribution)."""
    logits = sanitize_logits(logits)
    model_logprobs = torch.log_softmax(logits, dim=-1)
    if penalty is not None:
        logits = logits - penalty
    if temperature == 0.0:
        tokens = torch.argmax(logits, dim=-1)
    else:
        if noise is None:
            raise ValueError("sample_logits: temperature > 0 needs noise")
        sampling_logits = filter_logits(logits / temperature, top_p, top_k)
        tiny = torch.finfo(noise.dtype).tiny
        gumbel = -torch.log(-torch.log(noise.clamp_min(tiny)))
        tokens = torch.argmax(sampling_logits + gumbel, dim=-1)
    logprobs = torch.gather(model_logprobs, 1, tokens[:, None])[:, 0]
    return tokens, logprobs


def draw_noise(
    generators: Sequence[Optional[torch.Generator]],
    rows: Sequence[int],
    n_per: int,
    vocab: int,
    device,
) -> torch.Tensor:
    """[len(generators) * n_per, vocab] uniforms: request j's first
    ``rows[j]`` rows come from its own generator (one draw of
    ``[rows[j], vocab]`` per call, in request order); padding rows get 0.5."""
    noise = torch.full((len(generators) * n_per, vocab), 0.5, dtype=torch.float32, device=device)
    for j, (gen, n) in enumerate(zip(generators, rows)):
        if gen is not None and n > 0:
            noise[j * n_per : j * n_per + n] = torch.rand(
                (n, vocab), generator=gen, device=device, dtype=torch.float32
            )
    return noise


def model_top_logprobs(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k alternatives under the untempered model distribution, with the
    same non-finite-row sanitisation as :func:`sample_logits`. Returns (ids
    [B, k] int64, logprobs [B, k] f32, sorted descending)."""
    lps = torch.log_softmax(sanitize_logits(logits), dim=-1)
    top = torch.topk(lps, k, dim=-1)
    return top.indices, top.values
