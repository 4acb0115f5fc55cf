"""The mesh: SPMD tensor and sequence parallelism over ``torch.distributed``.

Counterpart of ``k_llms_tpu/parallel/``. JAX drives a whole mesh from one
process; here every rank is a process that builds the same engine, holds
its own shard of the weights and of the KV, and runs the same launches in
the same order: each host's first rank controls them and the others replay
its plans (:mod:`.controller`). Each process starts its host's
other ranks itself (:mod:`.launcher`, :mod:`.follower`), as JAX's one
process drives every local chip: a plain process when its client is built
(and it restarts a lost one), a process of JAX's multi-process start in
``initialize_multihost``. The
``(data, model)`` axes keep the JAX
names: samples (decode rows) and sequence chunks ride ``data``, the
Megatron weight split rides ``model``. The collectives of JAX's
``shard_map`` bodies are in :mod:`.collectives`.
"""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, auto_mesh, make_mesh
from .sharding import batch_spec, cache_specs, param_specs, shard_params

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "auto_mesh",
    "make_mesh",
    "param_specs",
    "cache_specs",
    "batch_spec",
]
