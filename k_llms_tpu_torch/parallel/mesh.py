"""Mesh construction.

Counterpart of ``k_llms_tpu/parallel/mesh.py``, over ranks instead of
devices. Axes:

- ``data``: the n consensus samples, and the sequence chunks of a
  sequence-parallel prefill;
- ``model``: tensor parallelism (Megatron: column-parallel in-projections,
  row-parallel out-projections, a vocabulary-sharded embedding and head).

A :class:`Mesh` wraps ``torch.distributed``'s ``DeviceMesh`` of shape
``(data, model)`` over the world's ranks and carries the transport of its
collectives. Rank ``r`` sits at ``(r // model, r % model)``, as device ``r``
of ``make_mesh``'s grid does in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


class Mesh:
    """This rank's view of a ``(data, model)`` grid of ranks: the axis
    sizes, its coordinate on each axis, the process group of each axis and
    the transport (``gloo`` or ``nccl``) every collective over it takes. A
    1x1 mesh without a process group is the trivial mesh: every collective
    over it is the identity."""

    def __init__(self, data: int, model: int, device_mesh=None, transport: str = "gloo"):
        self.shape: Dict[str, int] = {DATA_AXIS: int(data), MODEL_AXIS: int(model)}
        self.axis_names = AXES
        self.device_mesh = device_mesh
        self.transport = transport
        if device_mesh is None:
            self._coords = {DATA_AXIS: 0, MODEL_AXIS: 0}
            self._groups = {DATA_AXIS: None, MODEL_AXIS: None}
        else:
            coord = device_mesh.get_coordinate()
            self._coords = {DATA_AXIS: int(coord[0]), MODEL_AXIS: int(coord[1])}
            self._groups = {a: device_mesh.get_group(a) for a in AXES}

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self._coords[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def axis_ranks(self, axis: str):
        """Global ranks of this rank's group on ``axis``, in axis order."""
        g = self._groups[axis]
        if g is None:
            return [dist.get_rank() if dist.is_initialized() else 0]
        return dist.get_process_group_ranks(g)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"coords={self._coords}, transport={self.transport!r})")


def make_mesh(data: int, model: int, devices: Optional[Sequence[int]] = None) -> Mesh:
    """The ``(data, model)`` mesh over the world's ranks. Every rank of the
    world must call it, in the same order as its other group calls.
    ``devices`` (ranks, default the whole world) is checked as the JAX
    function checks its device list; the mesh covers the whole world. A
    mesh belongs to the world it was made in: a world started again in
    this process (:mod:`.launcher`) makes its own."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = len(devices) if devices is not None else world
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    if data * model != world:
        raise ValueError(
            f"mesh {data}x{model} must cover the world of {world} ranks (one rank per device)"
        )
    if not dist.is_initialized():
        return Mesh(1, 1)
    from torch.distributed.device_mesh import init_device_mesh

    transport = dist.get_backend()
    device_type = "cuda" if transport == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)
    return Mesh(data, model, dm, transport=transport)


def auto_mesh(devices: Optional[Sequence[int]] = None,
              model_parallel: Optional[int] = None) -> Mesh:
    """Factor the rank count into (data, model): all data, with
    ``model_parallel`` carved out when asked, as the JAX function does."""
    n = len(devices) if devices is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    mp = model_parallel or 1
    if n % mp != 0:
        raise ValueError(f"model_parallel={mp} does not divide device count {n}")
    return make_mesh(n // mp, mp, devices)


def model_shards(mesh: Optional[Mesh]) -> int:
    """Tensor-parallel degree: the model axis's size (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape[MODEL_AXIS]


def is_tensor_parallel(mesh: Optional[Mesh]) -> bool:
    return model_shards(mesh) > 1

