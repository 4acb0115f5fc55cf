"""Collectives over a named mesh axis: the port's spelling of the ``lax``
collectives that JAX's ``shard_map`` bodies use (``psum``, ``pmax``,
``all_gather``, ``ppermute``, ``all_to_all``).

One transport per process group, chosen when the world starts
(:mod:`.distributed`): ``nccl`` takes device tensors as they are; under
``gloo`` (the CPU, and ranks that share one card) every collective copies
its tensors to host memory and back, so the work stays on the card and only
the collective's bytes cross the host. Those bytes are counted in
:data:`COLLECTIVE_COUNTS` ``["host_staged_bytes"]``. No collective catches
an error to try another transport.

Every rank of the axis's group must make the same calls in the same order;
each returns the same bytes on every rank of the group (``psum`` and
``pmax`` are one ``all_reduce``, whose result every rank receives whole).
A collective over a trivial mesh (no process group) is the identity.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from ..analysis.lockcheck import note_device_dispatch
from .mesh import MODEL_AXIS, Mesh

#: Calls per collective, and the bytes staged through host memory under
#: ``gloo``, since the last :func:`reset_collective_counts`.
COLLECTIVE_COUNTS: Dict[str, int] = {
    "psum": 0,
    "pmax": 0,
    "all_gather": 0,
    "ppermute": 0,
    "all_to_all": 0,
    "gather": 0,
    "host_staged_bytes": 0,
}


def reset_collective_counts() -> None:
    for name in COLLECTIVE_COUNTS:
        COLLECTIVE_COUNTS[name] = 0


def _note(name: str) -> None:
    COLLECTIVE_COUNTS[name] += 1
    note_device_dispatch(f"collective {name}")


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.transport == "gloo" and x.device.type != "cpu"


def _to_wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` the transport can take (on the host under
    gloo): collectives work in place, and the caller's tensor stays as it
    was."""
    if _staged(mesh, x):
        COLLECTIVE_COUNTS["host_staged_bytes"] += x.numel() * x.element_size()
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone(memory_format=torch.contiguous_format)


def _from_wire(mesh: Mesh, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if y.device != like.device:
        COLLECTIVE_COUNTS["host_staged_bytes"] += y.numel() * y.element_size()
        return y.to(like.device)
    return y


def _all_reduce(name: str, x: torch.Tensor, axis: str, mesh: Mesh, op) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x
    _note(name)
    y = _to_wire(mesh, x)
    dist.all_reduce(y, op=op, group=group)
    return _from_wire(mesh, y, x)


def psum(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``lax.psum``)."""
    return _all_reduce("psum", x, axis, mesh, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """Elementwise maximum over the ranks of ``axis`` (``lax.pmax``)."""
    return _all_reduce("pmax", x, axis, mesh, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axis: str, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in axis order (a tiled
    ``lax.all_gather``)."""
    group = mesh.group(axis)
    if group is None:
        return x
    _note("all_gather")
    y = _to_wire(mesh, x)
    parts: List[torch.Tensor] = [torch.empty_like(y) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, y, group=group)
    return _from_wire(mesh, torch.cat(parts, dim=dim), x)


def gather_to_first(x: torch.Tensor, axis: str, mesh: Mesh, dim: int = 0):
    """The ranks' ``x`` concatenated along ``dim`` in axis order, on the
    axis's first rank only (``dist.gather``); the others send theirs and get
    None. Over a trivial mesh, ``x``."""
    group = mesh.group(axis)
    if group is None:
        return x
    _note("gather")
    y = _to_wire(mesh, x)
    first = mesh.axis_index(axis) == 0
    parts = [torch.empty_like(y) for _ in range(mesh.axis_size(axis))] if first else None
    dist.gather(y, parts, dst=mesh.axis_ranks(axis)[0], group=group)
    return _from_wire(mesh, torch.cat(parts, dim=dim), x) if first else None


def ppermute(x: torch.Tensor, axis: str, mesh: Mesh, shift: int = 1) -> torch.Tensor:
    """Ring shift (``lax.ppermute`` with ``perm = [(j, (j + shift) % P)]``):
    each rank sends ``x`` to the rank ``shift`` steps ahead on ``axis`` and
    returns what the rank ``shift`` steps behind sent."""
    group = mesh.group(axis)
    if group is None:
        return x
    _note("ppermute")
    P = mesh.axis_size(axis)
    me = mesh.axis_index(axis)
    if shift % P == 0:
        return x
    ranks = mesh.axis_ranks(axis)
    send = _to_wire(mesh, x)
    recv = torch.empty_like(send)
    ops = [
        dist.P2POp(dist.isend, send, ranks[(me + shift) % P], group=group),
        dist.P2POp(dist.irecv, recv, ranks[(me - shift) % P], group=group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _from_wire(mesh, recv, x)


def all_to_all(x: torch.Tensor, axis: str, mesh: Mesh, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all`` (tiled): ``x`` is cut into P equal chunks along
    ``split_dim``; chunk j goes to rank j of ``axis``, and the P chunks a
    rank receives are concatenated along ``concat_dim`` in axis order."""
    group = mesh.group(axis)
    if group is None:
        return x
    _note("all_to_all")
    P = mesh.axis_size(axis)
    if x.shape[split_dim] % P:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not divide by {P}")
    # Chunks along a leading axis, contiguous, so one all_to_all_single
    # moves them.
    chunks = torch.stack(torch.chunk(x, P, dim=split_dim))
    send = _to_wire(mesh, chunks)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    recv = _from_wire(mesh, recv, x)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


# -- differentiable collectives over ``model`` (Megatron's conjugate pair) -----
#
# The collectives above detach (``_to_wire``). The tensor-parallel boundaries
# of ``models/llama.py`` go through these three instead, so that a train
# step's backward crosses the ranks as GSPMD's transpose does in JAX. Each
# backward collective is one of the functions above, counted and staged as
# they are; the forward is the plain collective, so forward results and
# counts are those of ``psum`` and ``all_gather``. Over a mesh without a
# model group each is the identity.


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return psum(x, MODEL_AXIS, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, grad):
        return psum(grad, MODEL_AXIS, ctx.mesh), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.me, ctx.size, ctx.dim = mesh.axis_index(MODEL_AXIS), x.shape[dim], dim
        return all_gather(x, MODEL_AXIS, mesh, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.me * ctx.size, ctx.size), None, None


def _has_model_group(mesh: Mesh) -> bool:
    return mesh is not None and mesh.group(MODEL_AXIS) is not None


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of the ranks' partial ``x`` over ``model`` (a row-parallel
    output, the vocabulary-sharded embedding). Its gradient passes through
    unchanged: every model rank holds the whole sum and receives the whole
    gradient. (``torch.distributed.nn``'s all-reduce would sum that gradient
    again, M times the right one.)"""
    return _ReduceFromModel.apply(x, mesh) if _has_model_group(mesh) else x


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x``, replicated over ``model``, entering rank-specific work (a
    column-parallel projection, this rank's experts): the identity, whose
    gradient is the sum of the ranks' partial gradients."""
    return _CopyToModel.apply(x, mesh) if _has_model_group(mesh) else x


def gather_from_model(x: torch.Tensor, mesh: Mesh, dim: int = -1) -> torch.Tensor:
    """The ranks' shards of ``x`` concatenated along ``dim`` over ``model``
    (:func:`all_gather`); the gradient is this rank's slice of the whole
    one."""
    if not _has_model_group(mesh):
        return x
    return _GatherFromModel.apply(x, mesh, dim % x.dim())


class RankDivergenceError(RuntimeError):
    """Ranks of one SPMD program hold different values where every rank
    must hold the same (a host decision would branch apart and deadlock)."""


def assert_ranks_agree(x: torch.Tensor, mesh: Mesh, what: str = "value",
                       axis: str = None) -> None:
    """Raise :class:`RankDivergenceError` on every rank unless every rank of
    the world (or of this rank's group on ``axis``) holds the same ``x``
    (one ``all_gather`` over that group; a trivial mesh has nothing to
    compare)."""
    if mesh.device_mesh is None:
        return
    group = None if axis is None else mesh.group(axis)
    ranks = list(range(dist.get_world_size())) if axis is None else mesh.axis_ranks(axis)
    y = _to_wire(mesh, x)
    parts = [torch.empty_like(y) for _ in ranks]
    dist.all_gather(parts, y, group=group)
    differ = [ranks[i] for i, p in enumerate(parts) if not torch.equal(p, parts[0])]
    if differ:
        raise RankDivergenceError(
            f"ranks {differ} hold another {what} than rank {ranks[0]} "
            f"(rank {dist.get_rank()} checking)"
        )
