"""Causal-LM training step: next-token cross entropy, AdamW with optax's
numbers, and the (data, model)-sharded step.

Counterpart of ``k_llms_tpu/engine/training.py``, with its names and call
shape (``causal_lm_loss``; ``make_train_step`` returning ``(init_state,
train_step)``) in PyTorch's idiom: autograd stands for ``jax.value_and_grad``,
a ``torch.optim.Optimizer`` for the optax transformation, and the parameter
tree is updated in place.

JAX trains what it can differentiate: its Pallas kernels have no VJP, so a
config whose forward reaches one (``attention_impl="flash"``) fails under
``jax.grad``, and a quantized tree's integer leaves have no gradient. The
port's kernels have no backward either: the step refuses the same configs
and trees, before any work, with :class:`UntrainableError`.

On a mesh the step is SPMD, like the engine: every rank calls it with the
same global batch and its shard of the tree (``parallel.shard_params``). A
rank takes its rows by its ``data`` coordinate. The model's tensor-parallel
boundaries are differentiable collectives (``parallel/collectives.py``), so
the backward leaves each rank the gradient of its shard. The gradients are
then summed over ``data`` and each rank's optimizer steps its shard. The
loss a rank differentiates is its rows' summed NLL over the GLOBAL count of
valid targets, so the sum over ``data`` is the unsharded loss and gradient
(a mean of per-shard means is not, wherever the shards' pad masks differ).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.llama import check_supported, forward
from ..models.quant import QTensor
from ..ops.w4matmul import Q4Tensor
from ..parallel.collectives import psum
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

Params = Dict[str, Any]
#: Makes the optimizer over a tree's parameter tensors (the port's spelling
#: of an optax transformation).
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


class UntrainableError(ValueError):
    """A config or parameter tree the JAX package cannot train either: a
    forward through a kernel (no backward), or quantized weights. The
    message names the field or leaf."""


def adamw(params: List[torch.Tensor]) -> torch.optim.Optimizer:
    """``optax.adamw(1e-4)`` as a ``torch.optim.AdamW``, with every
    hyperparameter set to optax's value (torch's default weight decay is
    0.01, optax's 1e-4). The moments take each parameter's dtype, as
    optax keeps them."""
    return torch.optim.AdamW(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4, amsgrad=False, foreach=False)


def causal_lm_loss(
    config: ModelConfig, params: Params, tokens: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Next-token cross entropy over valid (non-pad) positions: f32 logits,
    ``log_softmax``, ``sum(nll * valid) / max(sum(valid), 1)``."""
    nll_sum, valid = _nll_sum(config, params, tokens, mask)
    return nll_sum / valid.clamp_min(1.0)


def _nll_sum(config, params, tokens, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL of the valid targets, their count), both f32."""
    logits, _ = forward(config, params, tokens, mask)
    logprobs = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logprobs, -1, tokens[:, 1:, None].long())[..., 0]
    valid = mask[:, 1:].float()
    return (nll * valid).sum(), valid.sum()


def _leaves(params: Params) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every weight, in the tree's order; the ``"mesh"``
    entry is no leaf."""
    yield "embed", params["embed"]
    for key, leaf in params["layers"].items():
        yield f"layers.{key}", leaf
    yield "final_norm", params["final_norm"]
    yield "lm_head", params["lm_head"]


def _refuse(config: ModelConfig, params: Optional[Params] = None) -> None:
    """Raise :class:`UntrainableError` for what the JAX step fails on."""
    if config.attention_impl == "flash":
        raise UntrainableError(
            f"{config.name}: attention_impl='flash' runs the flash kernel, which has no "
            "backward (JAX cannot differentiate its Pallas kernel either); train with "
            "attention_impl='xla'"
        )
    for path, leaf in _leaves(params) if params is not None else ():
        if isinstance(leaf, (QTensor, Q4Tensor)):
            kind = "int4" if isinstance(leaf, Q4Tensor) else "int8"
            raise UntrainableError(
                f"{config.name}: parameter {path} is quantized ({kind}); a quantized tree "
                "has no gradient (JAX refuses its integer leaves too)"
            )


def _step_mesh(params: Params, mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh the step runs on: the tree's (``shard_params`` leaves it
    there), which must be ``mesh`` when one is given."""
    tree_mesh = params.get("mesh")
    if mesh is None:
        return tree_mesh
    if tree_mesh is not mesh and mesh.axis_size(MODEL_AXIS) > 1:
        raise ValueError(
            "the step's mesh shards the model: pass this rank's shard of the tree "
            "(parallel.shard_params(tree, mesh, config))"
        )
    return mesh


def _psum_grads(leaves: List[torch.Tensor], mesh: Mesh) -> None:
    """Sum every leaf's gradient over ``data``: one ``psum`` per dtype of a
    flat buffer (a leaf without a gradient contributes zeros)."""
    for dtype in dict.fromkeys(p.dtype for p in leaves):
        group = [p for p in leaves if p.dtype == dtype]
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in group])
        flat = psum(flat, DATA_AXIS, mesh)
        offset = 0
        for p in group:
            p.grad = flat[offset: offset + p.numel()].view_as(p)
            offset += p.numel()


def make_train_step(
    config: ModelConfig,
    optimizer: Optional[OptimizerFactory] = None,
    mesh: Optional[Mesh] = None,
):
    """Returns ``(init_state, train_step)``.

    ``init_state(params)`` makes the optimizer over the tree's weights.
    ``optimizer`` is a callable from that list of tensors to a
    ``torch.optim.Optimizer`` (default :func:`adamw`, optax's
    ``adamw(1e-4)``): where JAX takes an optax transformation whose state
    the caller threads through, the port's state is the optimizer object,
    and its ``step()`` updates the tensors in place.

    ``train_step(params, opt_state, tokens, mask)`` returns ``(params,
    opt_state, loss)``: the same tree, updated in place, the optimizer, and
    the loss before the update as a 0-d f32 tensor (a shard from
    ``shard_params`` shares the leaves it does not cut with the full tree,
    which the step updates too). It runs on the tree's
    device (the card, or the CPU for a tree there). With a mesh (or a tree
    from ``shard_params``), every rank passes the same global batch, whose
    rows must divide over ``data``, and gets the global loss.

    A flash config is refused here, a quantized tree by both functions
    (:class:`UntrainableError`), before any work."""
    _refuse(config)
    check_supported(config)
    make_optimizer = optimizer or adamw

    def init_state(params: Params) -> torch.optim.Optimizer:
        _refuse(config, params)
        return make_optimizer([leaf for _, leaf in _leaves(params)])

    def train_step(params: Params, opt_state: torch.optim.Optimizer, tokens, mask):
        _refuse(config, params)
        leaves = [leaf for _, leaf in _leaves(params)]
        held = [p for group in opt_state.param_groups for p in group["params"]]
        if len(held) != len(leaves) or any(a is not b for a, b in zip(held, leaves)):
            raise ValueError("opt_state holds other tensors than this tree: make it with "
                             "init_state(params)")
        step_mesh = _step_mesh(params, mesh)
        device = leaves[0].device
        tokens, mask = torch.as_tensor(tokens).to(device), torch.as_tensor(mask).to(device)
        D = 1 if step_mesh is None else step_mesh.axis_size(DATA_AXIS)
        if tokens.shape[0] % D:
            raise ValueError(f"a batch of {tokens.shape[0]} rows does not divide over data={D}")
        if D > 1:
            rows = tokens.shape[0] // D
            lo = step_mesh.axis_index(DATA_AXIS) * rows
            tokens, mask = tokens[lo: lo + rows], mask[lo: lo + rows]
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                nll_sum, valid = _nll_sum(config, params, tokens, mask)
                count = valid.detach()
                if D > 1:
                    count = psum(count, DATA_AXIS, step_mesh)
                loss = nll_sum / count.clamp_min(1.0)
                loss.backward()
        finally:
            for p in leaves:
                p.requires_grad_(False)
        loss = loss.detach()
        if D > 1:
            _psum_grads(leaves, step_mesh)
            loss = psum(loss, DATA_AXIS, step_mesh)
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    return init_state, train_step
