"""Data-parallel training step, the framework's hot path.

Counterpart of ``horovod_tpu/parallel/dp.py`` (``make_train_step``,
``make_stateful_train_step``, ``make_eval_step``, ``replicate``,
``shard_batch``). One step runs forward and backward, the gradient allreduce
over the replica axes ``("data", "fsdp")`` fused per dtype
(``ops.fusion.fused_apply``; Average with fp32 accumulation unless
compression sets the wire dtype; with ``hierarchical`` a reduce-scatter over
``fsdp``, an allreduce over ``data`` and an all-gather over ``fsdp``), and
the optimizer update. The reference compiles the step into one XLA program
over a mesh; the port runs eagerly, one process per GPU, and reduces over the
``torch.distributed`` process groups created by ``init()``. Parameters,
non-gradient model state (floating buffers such as BatchNorm running
statistics) and optimizer state live in the model and the ``torch.optim``
optimizer and are updated in place.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.env import env_bool
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.ops.fusion import fused_apply, map_tree
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.parallel.collectives import Average, Op
from horovod_tpu_torch.parallel.mesh import REPLICA_AXES

# The replica axes a pure-DP step reduces over (reference dp.py:32).
DP_AXES = REPLICA_AXES


class TrainStepOutput(NamedTuple):
    loss: torch.Tensor
    aux: Any


class StatefulTrainStepOutput(NamedTuple):
    loss: torch.Tensor
    model_state: Dict[str, torch.Tensor]  # the synced floating buffers
    aux: Any


def _resolve_hierarchical(hierarchical: Optional[bool]) -> bool:
    """Env-default the two-level reduction (reference dp.py:35-43:
    ``HOROVOD_HIERARCHICAL_ALLREDUCE``). It needs two replica axes, which a
    port job always has (``fsdp`` may be of size 1)."""
    if hierarchical is None:
        hierarchical = env_bool("HOROVOD_HIERARCHICAL_ALLREDUCE")
    return bool(hierarchical)


def _make_grad_allreduce(op, compression, prescale_factor, postscale_factor,
                         hierarchical):
    """Reduce a list of gradients over the replica axes, fused per dtype
    (reference dp.py:127-144). With compression the allreduce runs in the
    wire dtype, without fp32 accumulation."""
    def red(g):
        ctx = None
        if compression is not None:
            g, ctx = compression.compress(g)
        kwargs = dict(op=op, prescale_factor=prescale_factor,
                      postscale_factor=postscale_factor,
                      accumulate_in_fp32=compression is None)
        if hierarchical:
            out = collectives.hierarchical_allreduce(
                g, outer_axis=DP_AXES[0], inner_axis=DP_AXES[1:], **kwargs)
        else:
            out = collectives.allreduce(g, axis=DP_AXES, **kwargs)
        if compression is not None:
            out = compression.decompress(out, ctx)
        return out
    return lambda grads: fused_apply(red, grads)


def _sync_aux(aux):
    """Float leaves averaged, integer leaves summed, others untouched."""
    def sync(v):
        if not isinstance(v, torch.Tensor):
            return v
        if v.is_floating_point():
            return collectives.allreduce(v.detach(), op=Average, axis=DP_AXES)
        if not v.is_complex() and v.dtype != torch.bool:
            return collectives.allreduce(v, op=collectives.Sum, axis=DP_AXES)
        return v
    return map_tree(sync, aux)


def _sync_state(tree):
    """Float leaves averaged over the replicas, every other leaf unchanged
    (reference dp.py:331-337)."""
    return map_tree(
        lambda v: collectives.allreduce(v.detach(), op=Average, axis=DP_AXES)
        if isinstance(v, torch.Tensor) and v.is_floating_point() else v,
        tree)


def fold_in(seed: int, index: int) -> int:
    """A 63-bit seed derived from ``seed`` and a replica index: distinct
    indices give unrelated seeds, the same pair always the same seed (the
    part ``jax.random.fold_in`` plays in the reference, dp.py:258)."""
    digest = hashlib.sha256(f"{int(seed)}/{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _check_options(sharded_update, bucket_bytes, op, compression):
    """Options the port does not have yet raise; returns the compression
    with ``Compression.none`` read as ``None``."""
    if sharded_update:
        raise NotImplementedError("sharded_update (ZeRO-1) is not ported "
                                  "yet; see ROADMAP.md queue A, 'int8 wire and "
                                  "ZeRO-1'")
    if bucket_bytes:
        raise NotImplementedError("bucket_bytes (bucketed overlap) is not "
                                  "ported yet; see ROADMAP.md queue A, "
                                  "'Bucketed overlap'")
    if op is collectives.Adasum:
        raise NotImplementedError("Adasum is not ported yet; see ROADMAP.md "
                                  "queue A, 'Remaining parallelism'")
    if compression is Compression.none:
        compression = None
    if compression is not None and getattr(compression, "quantized", False):
        raise NotImplementedError("int8 compression is not ported yet; see "
                                  "ROADMAP.md queue A, 'int8 wire and ZeRO-1'")
    return compression


def _to_device(batch, device):
    return map_tree(lambda x: x.to(device, non_blocking=True)
                    if isinstance(x, torch.Tensor) else x, batch)


def _make_local_loss(model, loss_fn, remat, device):
    """``local_loss(batch, seed) -> (loss, aux)``. With a seed, ``loss_fn``
    gets a third argument: a generator on ``device`` seeded from the seed
    and this replica's index (``fold_in``). The generator is made inside
    the function ``remat`` recomputes, so the recomputation draws the same
    numbers."""
    def run(batch, seed):
        if seed is None:
            return loss_fn(model, batch)
        gen = torch.Generator(device=device).manual_seed(seed)
        return loss_fn(model, batch, gen)

    def local_loss(batch, seed):
        if seed is not None:
            seed = fold_in(seed, collectives.axis_rank(DP_AXES))
        if remat:
            return checkpoint(run, batch, seed, use_reentrant=False)
        return run(batch, seed)
    return local_loss


def _place(model, device) -> None:
    """Check ``device`` against ``init()``'s and move the model there."""
    basics._require_init()
    if basics.device().type != device.type:
        raise ValueError(f"init() ran on {basics.device()}, the step asks "
                         f"for {device}")
    model.to(device)


def _prepare(model, loss_fn, device, remat, op, compression,
             prescale_factor, postscale_factor, sharded_update, bucket_bytes,
             hierarchical):
    """Set-up shared by make_train_step and make_stateful_train_step:
    returns the device, the trainable parameters, the gradient allreduce
    and ``local_loss``."""
    device = basics.resolve_device(device)
    compression = _check_options(sharded_update, bucket_bytes, op,
                                 compression)
    _place(model, device)
    params = [p for p in model.parameters() if p.requires_grad]
    allreduce_grads = _make_grad_allreduce(
        op, compression, prescale_factor, postscale_factor,
        _resolve_hierarchical(hierarchical))
    return (device, params, allreduce_grads,
            _make_local_loss(model, loss_fn, remat, device))


def _reduce_grads(params, allreduce_grads):
    with torch.no_grad():
        have = [p for p in params if p.grad is not None]
        for p, g in zip(have, allreduce_grads([p.grad for p in have])):
            p.grad = g


def make_train_step(model: nn.Module,
                    loss_fn: Callable,
                    optimizer: torch.optim.Optimizer,
                    *,
                    op: Op = Average,
                    compression=None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    remat: bool = False,
                    device=None,
                    sharded_update: bool = False,
                    bucket_bytes: Optional[int] = None,
                    hierarchical: Optional[bool] = None) -> Callable:
    """Build a data-parallel train step.

    ``loss_fn(model, batch) -> (loss, aux)`` computes the local loss on this
    replica's slice of the batch. The returned ``step(batch, seed=None) ->
    TrainStepOutput(loss, aux)`` moves the batch to the device, runs forward
    and backward, allreduces the gradients over the replica axes (fused per
    dtype, ``op`` with the pre/postscale factors; with ``compression`` in
    its wire dtype; ``hierarchical``, default ``HOROVOD_HIERARCHICAL_
    ALLREDUCE``, in two levels), steps ``optimizer`` and returns the
    replica-averaged loss. With a ``seed`` the step calls ``loss_fn(model,
    batch, generator)``, the generator seeded from the seed and the
    replica's index (dropout masks differ across replicas and repeat on a
    rerun). Leaves of ``aux`` are made replica-consistent: floating leaves
    averaged, integer leaves summed. ``remat=True`` recomputes activations
    in the backward pass (``torch.utils.checkpoint``, non-reentrant).
    ``device=None`` means the device ``init()`` chose (``cuda:local_rank``);
    without CUDA that raises unless ``device="cpu"`` is given. The model is
    moved to the device.
    """
    device, params, allreduce_grads, local_loss = _prepare(
        model, loss_fn, device, remat, op, compression, prescale_factor,
        postscale_factor, sharded_update, bucket_bytes, hierarchical)

    def step(batch, seed: Optional[int] = None) -> TrainStepOutput:
        batch = _to_device(batch, device)
        optimizer.zero_grad(set_to_none=True)
        loss, aux = local_loss(batch, seed)
        loss.backward()
        _reduce_grads(params, allreduce_grads)
        optimizer.step()
        loss = collectives.allreduce(loss.detach(), op=Average, axis=DP_AXES)
        return TrainStepOutput(loss, _sync_aux(aux))

    return step


def make_stateful_train_step(model: nn.Module,
                             loss_fn: Callable,
                             optimizer: torch.optim.Optimizer,
                             *,
                             op: Op = Average,
                             compression=None,
                             prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0,
                             remat: bool = False,
                             device=None,
                             sharded_update: bool = False,
                             bucket_bytes: Optional[int] = None,
                             hierarchical: Optional[bool] = None
                             ) -> Callable:
    """Train step for models with non-gradient state (reference
    dp.py:288-361): the model's floating buffers, such as BatchNorm running
    statistics, which ``loss_fn`` updates in place in its forward.

    Same arguments and step as :func:`make_train_step`; after the optimizer
    update the floating buffers are averaged over the replicas (one
    collective per dtype), the cross-replica statistics sync the reference
    provides via SyncBatchNormalization. The step returns
    ``StatefulTrainStepOutput(loss, model_state, aux)``: ``model_state``
    maps the buffers' names to the synced buffers; floating ``aux`` leaves
    are averaged and every other leaf passes through unchanged (integers
    are not summed, unlike :func:`make_train_step`). With ``remat`` the
    backward's recomputation would update the buffers a second time, so
    the step puts back their values from after the forward.
    """
    device, params, allreduce_grads, local_loss = _prepare(
        model, loss_fn, device, remat, op, compression, prescale_factor,
        postscale_factor, sharded_update, bucket_bytes, hierarchical)

    def step(batch, seed: Optional[int] = None) -> StatefulTrainStepOutput:
        batch = _to_device(batch, device)
        state = {n: b for n, b in model.named_buffers()
                 if b.is_floating_point()}
        optimizer.zero_grad(set_to_none=True)
        loss, aux = local_loss(batch, seed)
        after_forward = [b.clone() for b in state.values()] if remat else []
        loss.backward()
        _reduce_grads(params, allreduce_grads)
        optimizer.step()
        with torch.no_grad():
            for b, v in zip(state.values(), after_forward):
                b.copy_(v)
            synced = fused_apply(
                lambda v: collectives.allreduce(v, op=Average, axis=DP_AXES),
                list(state.values()))
            for b, v in zip(state.values(), synced):
                b.copy_(v)
        loss = collectives.allreduce(loss.detach(), op=Average, axis=DP_AXES)
        return StatefulTrainStepOutput(loss, state, _sync_state(aux))

    return step


def make_eval_step(model: nn.Module, apply_fn: Callable,
                   device=None) -> Callable:
    """Forward pass on this replica's slice with no gradient (reference
    dp.py:364-375): ``step(batch)`` returns ``apply_fn(model, batch)`` of
    the whole global batch, gathered over the replica axes in rank
    order."""
    device = basics.resolve_device(device)
    _place(model, device)

    def step(batch) -> torch.Tensor:
        with torch.no_grad():
            out = apply_fn(model, _to_device(batch, device))
        return collectives.allgather(out, axis=DP_AXES)

    return step


def replicate(model: nn.Module, root_rank: int = 0) -> nn.Module:
    """Make every replica hold ``root_rank``'s parameters and buffers
    (broadcast in place; reference analog: ``broadcast_parameters``)."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            t.copy_(collectives.broadcast(t, root_rank, axis=DP_AXES))
    return model


def shard_batch(batch, rank: Optional[int] = None,
                size: Optional[int] = None):
    """This replica's slice of the leading dim of every tensor in ``batch``
    (the leading dim must divide evenly)."""
    rank = basics.rank() if rank is None else rank
    size = basics.size() if size is None else size

    def shard(x):
        if not isinstance(x, torch.Tensor):
            return x
        n = x.shape[0]
        if n % size:
            raise ValueError(f"batch dim {n} not divisible by {size} "
                             "replicas")
        per = n // size
        return x[rank * per:(rank + 1) * per]
    return map_tree(shard, batch)
