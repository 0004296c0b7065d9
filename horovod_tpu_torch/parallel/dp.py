"""Data-parallel training step, the framework's hot path.

Counterpart of ``horovod_tpu/parallel/dp.py`` (``make_train_step``,
``replicate``, ``shard_batch``). One step runs forward and backward, the
gradient allreduce fused per dtype (``ops.fusion.fused_apply``; Average with
fp32 accumulation unless compression sets the wire dtype), and the optimizer
update. The reference compiles the step into one XLA program over a mesh;
the port runs eagerly, one process per GPU, and reduces over the
``torch.distributed`` process group created by ``init()``. Parameters and
optimizer state live in the model and the ``torch.optim`` optimizer and are
updated in place.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.ops.fusion import fused_apply, map_tree
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.parallel.collectives import Average, Op


class TrainStepOutput(NamedTuple):
    loss: torch.Tensor
    aux: Any


def _make_grad_allreduce(op, compression, prescale_factor, postscale_factor):
    """Reduce a list of gradients, fused per dtype (reference
    dp.py:127-144). With compression the allreduce runs in the wire dtype,
    without fp32 accumulation."""
    def red(g):
        ctx = None
        if compression is not None:
            g, ctx = compression.compress(g)
        out = collectives.allreduce(
            g, op=op, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor,
            accumulate_in_fp32=compression is None)
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
            return collectives.allreduce(v.detach(), op=Average)
        if not v.is_complex() and v.dtype != torch.bool:
            return collectives.allreduce(v, op=collectives.Sum)
        return v
    return map_tree(sync, aux)


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
    replica's slice of the batch. The returned ``step(batch) ->
    TrainStepOutput(loss, aux)`` moves the batch to the device, runs forward
    and backward, allreduces the gradients (fused per dtype, ``op`` with the
    pre/postscale factors; with ``compression`` in its wire dtype), steps
    ``optimizer`` and returns the replica-averaged loss. Leaves of ``aux``
    are made replica-consistent: floating leaves averaged, integer leaves
    summed. ``remat=True`` recomputes activations in the backward pass
    (``torch.utils.checkpoint``, non-reentrant). ``device=None`` means the
    device ``init()`` chose (``cuda:local_rank``); without CUDA that raises
    unless ``device="cpu"`` is given. The model is moved to the device.
    """
    device = basics.resolve_device(device)
    if sharded_update:
        raise NotImplementedError("sharded_update (ZeRO-1) is not ported "
                                  "yet; see ROADMAP.md queue A, 'int8 wire and "
                                  "ZeRO-1'")
    if bucket_bytes:
        raise NotImplementedError("bucket_bytes (bucketed overlap) is not "
                                  "ported yet; see ROADMAP.md queue A, "
                                  "'Bucketed overlap'")
    if hierarchical:
        raise NotImplementedError("hierarchical allreduce is not ported yet; "
                                  "see ROADMAP.md queue A, 'Collectives, the "
                                  "rest'")
    if op is collectives.Adasum:
        raise NotImplementedError("Adasum is not ported yet; see ROADMAP.md "
                                  "queue A, 'Remaining parallelism'")
    if compression is Compression.none:
        compression = None
    if compression is not None and getattr(compression, "quantized", False):
        raise NotImplementedError("int8 compression is not ported yet; see "
                                  "ROADMAP.md queue A, 'int8 wire and ZeRO-1'")
    basics._require_init()
    if basics.device().type != device.type:
        raise ValueError(f"init() ran on {basics.device()}, the step asks "
                         f"for {device}")
    model.to(device)
    params = [p for p in model.parameters() if p.requires_grad]
    allreduce_grads = _make_grad_allreduce(op, compression, prescale_factor,
                                           postscale_factor)

    def local_loss(batch):
        if remat:
            return checkpoint(loss_fn, model, batch, use_reentrant=False)
        return loss_fn(model, batch)

    def step(batch) -> TrainStepOutput:
        batch = map_tree(lambda x: x.to(device, non_blocking=True)
                          if isinstance(x, torch.Tensor) else x, batch)
        optimizer.zero_grad(set_to_none=True)
        loss, aux = local_loss(batch)
        loss.backward()
        with torch.no_grad():
            have = [p for p in params if p.grad is not None]
            for p, g in zip(have, allreduce_grads([p.grad for p in have])):
                p.grad = g
        optimizer.step()
        loss = collectives.allreduce(loss.detach(), op=Average)
        return TrainStepOutput(loss, _sync_aux(aux))

    return step


def replicate(model: nn.Module, root_rank: int = 0) -> nn.Module:
    """Make every replica hold ``root_rank``'s parameters and buffers
    (broadcast in place; reference analog: ``broadcast_parameters``)."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            t.copy_(collectives.broadcast(t, root_rank))
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
