"""Fused paged-decode attention: a hand-written CUDA kernel, its plain
version, and the dense-equivalent reference.

Counterpart of ``k_llms_tpu/ops/paged_attention.py``. One contract, three
functions:

- ``paged_decode_attention``: the fused op. Tensors on a card go to
  ``csrc/paged_decode.cu`` (the block-table gather is the kernel's K/V load,
  nothing dense is materialized); tensors on the CPU go to
  :func:`paged_decode_attention_plain`.
- ``paged_decode_attention_plain``: the kernel's function in plain PyTorch,
  on the kernel's arguments (page tables, phases, lengths).
- ``paged_decode_attention_split``: the kernel's decomposition in plain
  PyTorch (the split plan of :func:`paged_split_plan`, per-split partials,
  the ordered merge), for the tests: it takes the page ranges as an
  argument so that a wrong split can be shown to break the limit.
- ``paged_decode_attention_xla``: the reference on flat slot maps and masks,
  operation for operation the dense decode branch of ``models/llama.py`` —
  what the engine runs when the kernel is not selected.

``resolve_paged_attention_impl`` picks between the kernel ("cuda") and the
reference ("xla"): "auto" selects the kernel for a card and the reference on
the CPU; a model with an attention softcap or a sliding window (Gemma-2,
Mistral) resolves to the reference, as in the JAX package, where the kernel
does not serve those either. ``launch_paged_attention_impl`` applies the ``ops.paged_attn``
failpoint per launch: on the CPU the drill sends the launch to the
reference; on a card it fails the launch with a typed
:class:`KernelUnavailableError`, since nothing on a card gives way to the
plain version. Both are counted.

Masking contract: out-of-table positions point into the trash page; their
values are arbitrary but finite and every consumer masks their scores before
the softmax max, so they contribute an exact 0.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

from ..reliability import failpoints as _failpoints
from ..types.wire import BackendUnavailableError
from ..utils.observability import KERNEL_EVENTS
from . import _ext
from .attention import _SMS, NEG_INF

#: Values accepted by ``LocalEngine(paged_attention_impl=...)``: "pallas",
#: the JAX package's name for its kernel, selects the hand kernel ("cuda").
PAGED_ATTENTION_IMPLS = ("auto", "cuda", "pallas", "xla")


def resolve_paged_attention_impl(requested: str, *, device, config=None) -> str:
    """Pick the paged-attention implementation: "cuda" (the kernel) or "xla"
    (the reference), once per engine or loop build. "auto" takes the kernel
    on a card and the reference on the CPU; an explicit "cuda" on CPU
    tensors runs the kernel's plain version through the same wrapper;
    "pallas", the name a JAX ``BackendConfig`` carries, resolves to "cuda".
    A ``config`` with an attention softcap or a sliding window is outside
    the kernel's support and resolves to "xla", as in the JAX function; an
    explicit "cuda"/"pallas" request so resolved is counted as
    ``kernel.paged_attn_fallback.softcap`` or ``.sliding_window``, and
    "auto" is not counted."""
    if requested not in PAGED_ATTENTION_IMPLS:
        raise ValueError(
            f"paged_attention_impl must be one of {PAGED_ATTENTION_IMPLS}, got {requested!r}"
        )
    if requested == "xla":
        return "xla"
    if config is not None and config.attn_softcap is not None:
        blocked: Optional[str] = "softcap"
    elif config is not None and config.sliding_window is not None:
        blocked = "sliding_window"
    else:
        blocked = None
    if blocked is not None:
        if requested != "auto":
            KERNEL_EVENTS.record(f"kernel.paged_attn_fallback.{blocked}")
        return "xla"
    if requested != "auto":
        return "cuda"
    return "cuda" if torch.device(device).type == "cuda" else "xla"


class KernelUnavailableError(BackendUnavailableError):
    """The paged-attention kernel cannot run this launch (the
    ``ops.paged_attn`` drill on a card). A 503 like any unavailable backend:
    the circuit breaker counts it and the launch's members fail typed."""

    code = "kernel_unavailable"


def launch_paged_attention_impl(impl: str, *, device) -> str:
    """The implementation one paged launch runs, from the engine's resolved
    ``impl``. The ``ops.paged_attn`` failpoint (action ``fallback``) sends a
    launch on the CPU to the reference ("xla"), counted as
    ``kernel.paged_attn_fallback.failpoint``; on a card it raises
    :class:`KernelUnavailableError`, counted as
    ``kernel.paged_attn_unavailable.failpoint``. Nothing else changes the
    implementation. Every launch that runs is counted as a cuda or an xla
    dispatch."""
    spec = _failpoints.fire("ops.paged_attn")
    if spec is not None and spec.action == "fallback":
        if torch.device(device).type == "cuda":
            KERNEL_EVENTS.record("kernel.paged_attn_unavailable.failpoint")
            raise KernelUnavailableError(
                "paged attention kernel unavailable for this launch (ops.paged_attn drill)"
            )
        KERNEL_EVENTS.record("kernel.paged_attn_fallback.failpoint")
        impl = "xla"
    if impl == "cuda":
        KERNEL_EVENTS.record("kernel.paged_attn_cuda_dispatch")
    else:
        KERNEL_EVENTS.record("kernel.paged_attn_xla_dispatch")
    return impl


def paged_decode_attention_xla(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    prefix_idx: torch.Tensor,
    gen_idx: torch.Tensor,
    new_k: torch.Tensor,
    new_v: torch.Tensor,
    write_index: torch.Tensor,
    key_mask: torch.Tensor,
    prefix_mask: torch.Tensor,
    *,
    sm_scale: float,
    softcap: Optional[float] = None,
    prefix_lengths: Optional[torch.Tensor] = None,
    flash_prefix: bool = False,
) -> torch.Tensor:
    """Reference paged decode attention, the dense decode math on gathered
    pages (``softcap`` on the scaled scores before the masks, as there). q/new_k/new_v: ``[B, Sq, QH|KVH, D]``; pool_k/pool_v: one layer's
    pool ``[pages * page_size, KVH, D]``; prefix_idx ``[B|R, P]`` / gen_idx
    ``[B, G]``: flat pool slots per logical position; write_index ``[B]``:
    each row's offset into its gen slots; key_mask ``[B, Sq, G]`` /
    prefix_mask ``[B, Sq, P]``. ``flash_prefix`` (with ``prefix_lengths``
    [R]) runs the decode-prefix kernel on the gathered prefix and merges the
    tail, as the dense step does. Returns ``[B, Sq, QH, D]`` f32."""
    from ..models.llama import decode_attention

    pk, pv = pool_k[prefix_idx.long()], pool_v[prefix_idx.long()]  # [B|R, P, KVH, D]
    gk, gv = pool_k[gen_idx.long()], pool_v[gen_idx.long()]  # [B, G, KVH, D]
    # The dense path's per-row cache write: the fresh column lands at each
    # row's own offset before attention reads it.
    B, Sq = q.shape[0], q.shape[1]
    rows = torch.arange(B, device=q.device)[:, None]
    cols = write_index.long()[:, None] + torch.arange(Sq, device=q.device)[None, :]
    gk[rows, cols] = new_k.to(gk.dtype)
    gv[rows, cols] = new_v.to(gv.dtype)
    return decode_attention(
        q, gk, gv, key_mask, pk, pv, prefix_mask, prefix_lengths,
        scale=sm_scale, flash_prefix=flash_prefix, softcap=softcap,
    )


def paged_attention_page_tables(
    prefix_idx: torch.Tensor, gen_idx: torch.Tensor, page_size: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Derive per-row PAGE tables from flat-SLOT index maps:
    ``prefix_pages [B|R, ceil(P/ps)]``, ``gen_pages [B, ceil(G/ps) + 1]`` and
    ``gen_phase [B]`` (the in-page offset of gen position 0). The +1 gen page
    absorbs the phase shift's worst case. Layer-invariant: computed once per
    decode step."""
    ps = page_size
    prefix_pages = prefix_idx[..., ::ps] // ps
    G = gen_idx.shape[-1]
    NG = -(-G // ps) + 1
    phase = gen_idx[:, :1] % ps  # [B, 1]
    starts = torch.arange(NG, device=gen_idx.device)[None, :] * ps - phase
    src = starts.clamp(0, G - 1).long()
    gen_pages = torch.gather(gen_idx, 1, src) // ps
    return (
        prefix_pages.to(torch.int32),
        gen_pages.to(torch.int32),
        phase[:, 0].to(torch.int32),
    )


def paged_decode_attention_plain(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    prefix_pages: torch.Tensor,
    gen_pages: torch.Tensor,
    gen_phase: torch.Tensor,
    new_k: torch.Tensor,
    new_v: torch.Tensor,
    prompt_lens: torch.Tensor,
    gen_lens: torch.Tensor,
    *,
    page_size: int,
    sm_scale: float,
) -> torch.Tensor:
    """The paged-decode kernel's function in plain PyTorch: gather every
    table page, mask slots outside ``[0, limit)``, append the fresh column,
    one f32 softmax. Same arguments and result as
    :func:`paged_decode_attention`."""
    B, QH, D = q.shape
    KVH = pool_k.shape[1]
    G = QH // KVH
    ps = page_size
    NP = prefix_pages.shape[1]
    if prefix_pages.shape[0] != B:  # [R, NP] shared prefix -> per-row table
        prefix_pages = prefix_pages.repeat_interleave(B // prefix_pages.shape[0], dim=0)
    tables = torch.cat([prefix_pages, gen_pages], dim=1).long()  # [B, NP + NG]
    slots = (tables[:, :, None] * ps + torch.arange(ps, device=q.device)).reshape(B, -1)
    k = pool_k[slots].float()  # [B, (NP+NG)*ps, KVH, D]
    v = pool_v[slots].float()
    j = torch.arange(tables.shape[1], device=q.device)[:, None]
    offs = torch.arange(ps, device=q.device)[None, :]
    is_prefix = (j < NP)[None]  # [1, NP+NG, 1]
    pos = torch.where(
        is_prefix, j * ps + offs, (j - NP) * ps + offs - gen_phase.long()[:, None, None]
    )
    limit = torch.where(is_prefix, prompt_lens.long()[:, None, None], gen_lens.long()[:, None, None])
    valid = ((pos >= 0) & (pos < limit)).reshape(B, 1, 1, -1)

    qg = q.float().reshape(B, KVH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k) * sm_scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    s_new = torch.einsum("bhgd,bhd->bhg", qg, new_k.float())[..., None] * sm_scale
    w = torch.softmax(torch.cat([s, s_new], dim=-1), dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w[..., :-1], v)
    out = out + w[..., -1:] * new_v.float()[:, :, None, :]
    return out.reshape(B, QH, D)


#: Rows of a request one CTA of the kernel serves at most.
_MAX_CHUNK_ROWS = 32


def paged_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel of ``csrc/paged_decode.cu`` a CUDA call takes: "tc" (bf16
    on the tensor cores) at head dims 64, 128 and 256 in bf16, else "simt"
    (f32 products on the CUDA cores)."""
    return "tc" if dtype == torch.bfloat16 and head_dim in (64, 128, 256) else "simt"


def paged_split_plan(B: int, R: int, QH: int, KVH: int, D: int, NP: int,
                     dtype: torch.dtype) -> Tuple[str, int, int]:
    """How the kernel cuts the work: ``(route, rows_per_cta, splits)``.

    A CTA serves ``rows_per_cta`` rows of one request (all of them when
    their ``rows * G`` query rows fit one or two m16 tiles on the tensor
    cores, or ``rows * G * D <= 1024`` on the CUDA cores) for one kv head,
    over one of ``splits`` contiguous ranges of the request's valid prefix
    pages; each row's generated pages are one more split of that row alone.
    ``splits`` is the fewest that put about one prefix CTA on each of the
    card's 132 SMs, at most one per table page."""
    n_per, G = B // R, QH // KVH
    route = paged_route(dtype, D)
    cap = 32 // G if route == "tc" else (128 * 8) // (G * D)
    rpc = max(1, min(n_per, cap, _MAX_CHUNK_ROWS))
    chunks = -(-n_per // rpc)
    splits = max(1, min(NP, -(-_SMS // (R * chunks * KVH))))
    return route, rpc, splits


def split_page_ranges(n_pages: int, splits: int) -> List[Tuple[int, int]]:
    """The pages ``[lo, hi)`` each prefix split walks, when the request has
    ``n_pages`` pages with a valid slot: contiguous, in order, sizes within
    one of each other (some empty when there are more splits than pages)."""
    return [(s * n_pages // splits, (s + 1) * n_pages // splits) for s in range(splits)]


def paged_work_items(
    B: int, R: int, QH: int, KVH: int, D: int, NP: int, NG: int, page_size: int,
    dtype: torch.dtype, prompt_lens: List[int], gen_lens: List[int], gen_phase: List[int],
    page_ranges: Callable[[int, int], List[Tuple[int, int]]] = split_page_ranges,
) -> Tuple[int, List[Tuple[str, int, List[int], int, range]]]:
    """The kernel's CTAs for one kv head, in grid order, as
    ``(kind, split, rows, table_row, pages)``: per request and row chunk,
    a "prefix" item for each of :func:`paged_split_plan`'s splits (table row
    = the request, pages from ``page_ranges`` over the pages where some row
    of the chunk has a valid slot), then a "gen" item per row of the chunk
    (table row = the row, its generated pages with a valid slot). Returns
    ``(splits, items)``."""
    ps = page_size
    _, rpc, splits = paged_split_plan(B, R, QH, KVH, D, NP, dtype)
    n_per = B // R
    items = []
    for r in range(R):
        for c in range(-(-n_per // rpc)):
            rows = list(range(r * n_per + c * rpc, r * n_per + min(n_per, (c + 1) * rpc)))
            max_len = max(0, *(prompt_lens[b] for b in rows))
            for z, (lo, hi) in enumerate(page_ranges(min(NP, -(-max_len // ps)), splits)):
                items.append(("prefix", z, rows, r, range(lo, hi)))
            for b in rows:
                n_gen = min(NG, -(-(gen_phase[b] + gen_lens[b]) // ps)) if gen_lens[b] > 0 else 0
                items.append(("gen", splits, [b], b, range(n_gen)))
    return splits, items


def paged_decode_attention_split(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    prefix_pages: torch.Tensor,
    gen_pages: torch.Tensor,
    gen_phase: torch.Tensor,
    new_k: torch.Tensor,
    new_v: torch.Tensor,
    prompt_lens: torch.Tensor,
    gen_lens: torch.Tensor,
    *,
    page_size: int,
    sm_scale: float,
    page_ranges: Callable[[int, int], List[Tuple[int, int]]] = split_page_ranges,
) -> torch.Tensor:
    """The kernel's split and merge in plain f32 PyTorch, on the kernel's
    arguments: each item of :func:`paged_work_items` gives its rows' (un-
    normalised out, max, denominator) over its pages, then each row's items
    are merged in split order with the fresh column folded in last. A page
    id outside the pool makes the rows with a valid slot in it NaN."""
    B, QH, D = q.shape
    KVH = pool_k.shape[1]
    G = QH // KVH
    ps = page_size
    R, NP = prefix_pages.shape
    num_pages = pool_k.shape[0] // ps
    # kllms: ignore[host-sync-hot-path] — port-only: the plain model of K1's split runs on CPU tensors only; the card path launches the kernel with no host value
    plens, glens, phases = prompt_lens.tolist(), gen_lens.tolist(), gen_phase.tolist()
    splits, items = paged_work_items(B, R, QH, KVH, D, NP, gen_pages.shape[1], ps, q.dtype,
                                     plens, glens, phases, page_ranges)
    qf = q.float().reshape(B, KVH, G, D)
    # kllms: ignore[host-sync-hot-path] — port-only: the plain model of K1's split runs on CPU tensors only; the card path launches the kernel with no host value
    tables = {"prefix": prefix_pages.tolist(), "gen": gen_pages.tolist()}
    parts = {b: [] for b in range(B)}  # row -> [(split, o, m, l, bad)]
    for kind, z, rows, table_row, pages in items:
        table = tables[kind][table_row]
        for b in rows:
            offset, limit = (phases[b], glens[b]) if kind == "gen" else (0, plens[b])
            slots, bad = [], False
            for j in pages:
                base = j * ps - offset
                if not (base < limit and base + ps > 0):
                    continue
                if not 0 <= table[j] < num_pages:
                    bad = True
                    continue
                slots += [table[j] * ps + s for s in range(ps) if 0 <= base + s < limit]
            o = torch.zeros((KVH, G, D), device=q.device)
            m = torch.full((KVH, G), -math.inf, device=q.device)
            l = torch.zeros((KVH, G), device=q.device)
            if slots:
                idx = torch.tensor(slots, device=q.device)
                sc = torch.einsum("hgd,nhd->hgn", qf[b], pool_k[idx].float()) * sm_scale
                m = sc.amax(-1)
                p = torch.exp(sc - m[..., None])
                l = p.sum(-1)
                o = torch.einsum("hgn,nhd->hgd", p, pool_v[idx].float())
            parts[b].append((z, o, m, l, bad))
    out = torch.empty((B, KVH, G, D), dtype=torch.float32, device=q.device)
    for b in range(B):
        ordered = sorted(parts[b], key=lambda part: part[0])
        m = torch.stack([pm for _, _, pm, _, _ in ordered]).amax(0)
        acc = torch.zeros((KVH, G, D), device=q.device)
        l = torch.zeros((KVH, G), device=q.device)
        for _, po, pm, pl, _ in ordered:
            w = torch.where(pm == -math.inf, torch.zeros_like(pm), torch.exp(pm - m))
            acc = acc + w[..., None] * po
            l = l + w * pl
        s_new = torch.einsum("hgd,hd->hg", qf[b], new_k[b].float()) * sm_scale
        m_fin = torch.maximum(m, s_new)
        alpha = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp(m - m_fin))
        p_new = torch.exp(s_new - m_fin)
        out[b] = (acc * alpha[..., None] + p_new[..., None] * new_v[b].float()[:, None, :]) / (
            l * alpha + p_new)[..., None]
        if any(bad for *_, bad in ordered):
            out[b] = math.nan
    return out.reshape(B, QH, D)


def paged_decode_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    prefix_pages: torch.Tensor,
    gen_pages: torch.Tensor,
    gen_phase: torch.Tensor,
    new_k: torch.Tensor,
    new_v: torch.Tensor,
    prompt_lens: torch.Tensor,
    gen_lens: torch.Tensor,
    *,
    page_size: int,
    sm_scale: float,
) -> torch.Tensor:
    """Fused paged decode attention (one query position per row).

    q: [B, QH, D]; pool_k/pool_v: one layer's pool [pages * page_size, KVH,
    D]; prefix_pages [B|R, NP] (an [R, NP] table is shared by each request's
    B/R request-major rows) / gen_pages [B, NG] / gen_phase [B]: from
    :func:`paged_attention_page_tables`; new_k/new_v [B, KVH, D]: this step's
    fresh column; prompt_lens / gen_lens [B]: per-row valid counts (the
    current token excluded). Returns [B, QH, D] f32.

    Tensors on a card go to the CUDA kernel (or the call raises); tensors on
    the CPU go to :func:`paged_decode_attention_plain`.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, pool_k, pool_v, prefix_pages, gen_pages, gen_phase, new_k, new_v,
            prompt_lens, gen_lens, page_size=page_size, sm_scale=sm_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    B, QH, D = q.shape
    KVH = pool_k.shape[1]
    ps = int(page_size)
    R, NP = prefix_pages.shape
    NG = gen_pages.shape[1]
    if (
        pool_k.dim() != 3 or pool_k.shape != pool_v.shape or pool_k.shape[2] != D
        or pool_k.shape[0] % ps or QH % KVH or R == 0 or B % R
        or gen_pages.shape[0] != B or new_k.shape != (B, KVH, D) or new_v.shape != new_k.shape
    ):
        raise ValueError(
            f"paged_decode_attention: bad shapes q={tuple(q.shape)} pool={tuple(pool_k.shape)} "
            f"prefix_pages={tuple(prefix_pages.shape)} gen_pages={tuple(gen_pages.shape)} "
            f"new_k={tuple(new_k.shape)} page_size={ps}"
        )
    if D not in (16, 64, 128, 256) or (QH // KVH) * D > 1024:
        raise ValueError(f"paged_decode_attention: head dim {D} x group {QH // KVH} unsupported")
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32) or any(
        t.dtype != dt for t in (pool_k, pool_v, new_k, new_v)
    ):
        raise ValueError("paged_decode_attention: q, pools and columns must share bf16 or f32")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v), ("new_k", new_k), ("new_v", new_v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must be contiguous, 16-byte aligned, on {q.device}")
    ints = [
        t.to(device=q.device, dtype=torch.int32).contiguous()
        for t in (prefix_pages, gen_pages, gen_phase.reshape(B), prompt_lens.reshape(B), gen_lens.reshape(B))
    ]
    route, rpc, splits = paged_split_plan(B, R, QH, KVH, D, NP, dt)
    out = torch.empty((B, QH, D), dtype=torch.float32, device=q.device)
    o_part = torch.empty((splits + 1, B, QH, D), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((splits + 1, B, QH, 2), dtype=torch.float32, device=q.device)
    lib = _ext.load("paged_decode")
    status = lib.kllms_paged_decode_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        ints[0].data_ptr(), ints[1].data_ptr(), ints[2].data_ptr(),
        new_k.data_ptr(), new_v.data_ptr(), ints[3].data_ptr(), ints[4].data_ptr(),
        out.data_ptr(), o_part.data_ptr(), ml_part.data_ptr(),
        B, QH, KVH, D, R, NP, NG, ps, pool_k.shape[0] // ps,
        int(dt == torch.bfloat16), int(route == "tc"), rpc, splits, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _ext.check_status("paged_decode_attention", status)
    _ext.note_launch("paged_decode_attention")
    return out
