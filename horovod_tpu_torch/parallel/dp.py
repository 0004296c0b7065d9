"""Data-parallel training step, the framework's hot path.

Counterpart of ``horovod_tpu/parallel/dp.py`` (``make_train_step``,
``make_stateful_train_step``, ``make_eval_step``, ``replicate``,
``shard_batch``). One step runs forward and backward, the gradient exchange
over the replica axes ``("data", "fsdp")`` and the optimizer update. The
exchange fuses the gradients per dtype, or per (bucket, dtype) with a
bucket bound, and reduces each fusion: an allreduce (Average with fp32
accumulation unless compression sets the wire dtype; with ``hierarchical``
a reduce-scatter over ``fsdp``, an allreduce over ``data`` and an
all-gather over ``fsdp``), the int8 quantized allreduce, Adasum, or with
``sharded_update`` the ZeRO-1 reduce-scatter, shard update and all-gather
(``parallel/zero.py``). The reference compiles the step into one XLA
program over a mesh and overlaps by dependency structure; the port runs
eagerly, one process per GPU, reduces over the ``torch.distributed``
process groups created by ``init()``, and overlaps for real: with a bucket
bound each bucket's collectives are launched from the gradient hooks while
the backward still runs. Parameters, non-gradient model state (floating
buffers such as BatchNorm running statistics) and optimizer state live in
the model and the ``torch.optim`` optimizer and are updated in place.
"""

from __future__ import annotations

import functools
import hashlib
import weakref
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.env import env_bool
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.metrics import timed_step
from horovod_tpu_torch.ops.fusion import fused_apply, map_tree
from horovod_tpu_torch.parallel import collectives, zero
from horovod_tpu_torch.parallel.bucketing import (Layout, fuse,
                                                  plan_units_in,
                                                  reference_layout,
                                                  resolve_bucket_bytes,
                                                  unfuse)
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


class _Exchange:
    """The gradient exchange of a train step over units of parameters (one
    per dtype, or per (bucket, dtype) with a bucket bound), each reduced by
    ``start(unit, grads) -> Pending``.

    With ``overlap`` a post-accumulate-grad hook on every parameter counts
    the unit's gradients in, and a unit is launched (its collectives issued
    with ``async_op=True``) once all of its gradients have accumulated and
    every earlier unit has been launched: units go out in the same order
    on every replica, as the collectives need. A tied weight accumulates
    once, after all of its uses. Units whose parameters got no gradient
    never fill; ``finish()`` launches whatever is left, in unit order, then
    waits on every unit. A parameter without a gradient reduces as zeros,
    as ``jax.value_and_grad`` gives an unused leaf a zero gradient."""

    def __init__(self, params, units, start, overlap: bool):
        self.params, self.units, self._start = params, units, start
        self._active = False
        # units launched before the last gradient hook of the last backward
        self.early_launches = 0
        if overlap:
            # the hooks hold the exchange weakly and go with it
            me = weakref.ref(self)
            handles = [params[i].register_post_accumulate_grad_hook(
                functools.partial(_on_grad, me, u))
                for u, idxs in enumerate(units) for i in idxs]
            weakref.finalize(self, _remove_hooks, handles)

    def begin(self) -> None:
        """Arm the hooks for one backward."""
        self._left = [len(idxs) for idxs in self.units]
        self._pending: list = [None] * len(self.units)
        self._next = 0
        self.early_launches = 0
        self._active = True

    def on_grad(self, unit: int) -> None:
        """One gradient of ``unit`` has accumulated."""
        if not self._active:
            return
        self.early_launches = self._next
        self._left[unit] -= 1
        while self._next < len(self.units) and not self._left[self._next]:
            self._launch(self._next)

    def _launch(self, unit: int) -> None:
        idxs = self.units[unit]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in (self.params[i] for i in idxs)]
        self._pending[unit] = (idxs, self._start(unit, grads))
        self._next = unit + 1

    def finish(self) -> list:
        """``(unit, parameter positions, result)`` of every unit, in unit
        order, after waiting on each. The exchange then holds none of the
        step's buffers."""
        self._active = False
        while self._next < len(self.units):
            self._launch(self._next)
        pending, self._pending = self._pending, []
        return [(u, idxs, work.wait())
                for u, (idxs, work) in enumerate(pending)]


def _on_grad(exchange_ref, unit: int, _param) -> None:
    exchange = exchange_ref()
    if exchange is not None:
        exchange.on_grad(unit)


def _remove_hooks(handles) -> None:
    for handle in handles:
        handle.remove()


def _translated(step: Callable) -> Callable:
    """``step`` with a backend failure of any of its collectives, at issue
    or at wait, raised as ``HorovodInternalError``: the one error an
    elastic job recovers from (``basics.translate_failures``)."""
    @functools.wraps(step)
    def run(*args, **kwargs):
        with basics.translate_failures():
            return step(*args, **kwargs)
    return run


def _check_compression(compression):
    """``Compression.none`` reads as None."""
    return None if compression is Compression.none else compression


def _replicated_reduce(op, compression, prescale_factor, postscale_factor,
                       hierarchical, align, units, layout):
    """``start(unit, grads) -> Pending`` of the replicated path (reference
    dp.py:84-144): the unit's gradients (of the parameters ``units[unit]``,
    each laid out as ``layout`` says) fused into one flat tensor and
    allreduced over the replica axes, quantized (int8), two-level, or in
    the compressor's wire dtype (without fp32 accumulation)."""
    if op is collectives.Adasum:
        # per-tensor coefficients, one fused pass; compression and buckets
        # do not apply (reference dp.py:117-125)
        def adasum(_unit, grads):
            outs = collectives.grouped_allreduce(
                grads, op=op, axis=DP_AXES, prescale_factor=prescale_factor,
                postscale_factor=postscale_factor)
            return collectives.Pending([], lambda: outs)
        return adasum
    quantized = getattr(compression, "quantized", False)

    def start(unit, grads):
        idxs = units[unit]
        grads = [layout.to_ref(i, g) for i, g in zip(idxs, grads)]
        shapes = [g.shape for g in grads]  # the gradients are not kept
        flat = fuse(grads, align)
        if quantized:
            pending = collectives.quantized_allreduce(
                flat, op=op, axis=DP_AXES, prescale_factor=prescale_factor,
                postscale_factor=postscale_factor,
                block_size=compression.block_size, async_op=True)
        else:
            ctx = None
            if compression is not None:
                flat, ctx = compression.compress(flat)
            kwargs = dict(op=op, prescale_factor=prescale_factor,
                          postscale_factor=postscale_factor,
                          accumulate_in_fp32=compression is None,
                          async_op=True)
            if hierarchical:
                pending = collectives.hierarchical_allreduce(
                    flat, outer_axis=DP_AXES[0], inner_axis=DP_AXES[1:],
                    **kwargs)
            else:
                pending = collectives.allreduce(flat, axis=DP_AXES, **kwargs)
            if compression is not None:
                pending = pending.then(
                    lambda out: compression.decompress(out, ctx))
        return pending.then(lambda out: [
            layout.from_ref(i, r)
            for i, r in zip(idxs, unfuse(out, shapes, align))])
    return start


class _ReplicatedUpdate:
    """Allreduce the gradients, then ``optimizer.step()`` on every
    replica."""

    def __init__(self, optimizer, params, exchange):
        self.optimizer, self.params, self.exchange = \
            optimizer, params, exchange

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        for _, idxs, grads in self.exchange.finish():
            for i, g in zip(idxs, grads):
                self.params[i].grad = g
        self.optimizer.step()


class _ShardedUpdate:
    """ZeRO-1 (``parallel/zero.py``): reduce-scatter the gradients, update
    this replica's shards, all-gather the updates into the parameters."""

    def __init__(self, sopt, exchange, compression):
        self.sopt, self.exchange, self.compression = \
            sopt, exchange, compression

    def zero_grad(self) -> None:
        # the model's parameters are not the optimizer's
        for p in self.sopt.params:
            p.grad = None
        self.sopt.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        shard_grads = [g for _, _, g in self.exchange.finish()]
        for p in self.sopt.params:
            p.grad = None
        zero.apply_sharded_update(self.sopt, shard_grads, self.compression)


def _make_update(optimizer, params, op, compression, prescale_factor,
                 postscale_factor, hierarchical, sharded_update,
                 bucket_bytes):
    """The gradient exchange and optimizer update of a step (reference
    dp.py:46-144), with the reference's refusals of incompatible
    options."""
    quantized = getattr(compression, "quantized", False)
    if sharded_update:
        if op is collectives.Adasum:
            raise ValueError("sharded_update is incompatible with Adasum — "
                             "Adasum has no reduce-scatter form")
        if hierarchical:
            raise ValueError(
                "sharded_update is incompatible with hierarchical allreduce "
                "— the sharded pipeline already reduce-scatters over all "
                "reduce axes; unset hierarchical= (or "
                "HOROVOD_HIERARCHICAL_ALLREDUCE)")
        zero.check_op(op)
        if not isinstance(optimizer, zero.ShardedOptimizer):
            raise ValueError("sharded_update=True needs the optimizer built "
                             "by zero.sharded_optimizer(model, ...)")
        if [id(p) for p in optimizer.params] != [id(p) for p in params]:
            raise ValueError("the sharded optimizer was built over other "
                             "parameters than the model's")
        if optimizer.bucket_bytes != bucket_bytes:
            raise ValueError(
                f"the sharded optimizer was built with bucket_bytes="
                f"{optimizer.bucket_bytes}, the step has {bucket_bytes}: "
                "the shard layout depends on it")
        if quantized and compression.block_size != optimizer.block_size:
            raise ValueError("int8 block size differs from the sharded "
                             "optimizer's")
        start = functools.partial(
            zero.reduce_scatter_grads, optimizer, op=op,
            compression=compression, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor)
        exchange = _Exchange(params, [g.indices for g in optimizer.groups],
                             start, overlap=bucket_bytes > 0)
        return _ShardedUpdate(optimizer, exchange, compression)
    if isinstance(optimizer, zero.ShardedOptimizer):
        raise ValueError("a zero.sharded_optimizer needs sharded_update=True")
    exchange = replicated_exchange(params, op, compression, prescale_factor,
                                   postscale_factor, hierarchical,
                                   bucket_bytes)
    return _ReplicatedUpdate(optimizer, params, exchange)


def replicated_exchange(params, op, compression, prescale_factor,
                        postscale_factor, hierarchical,
                        bucket_bytes) -> _Exchange:
    """The replicated path's gradient exchange of ``params``, with the
    reference's refusals: fused per dtype, or per (bucket, dtype) with a
    bound (launched from the gradient hooks); int8 in the reference's leaf
    order and layout (``bucketing.reference_layout``)."""
    quantized = getattr(compression, "quantized", False)
    if quantized:
        if hierarchical:
            raise ValueError(
                "quantized compression is incompatible with hierarchical "
                "allreduce — the quantized collective is already a "
                "reduce-scatter/all-gather composition")
        if op not in (Average, collectives.Sum):
            raise ValueError(f"quantized_allreduce supports Sum/Average, "
                             f"got {op}")
    adasum = op is collectives.Adasum
    bucketed = bucket_bytes > 0 and not adasum
    layout = reference_layout(params) if quantized else \
        Layout.plain(len(params))
    # int8 buckets pad every tensor to whole blocks: the result is then the
    # same bits for every bucket bound
    units, align = plan_units_in(layout, params,
                                 bucket_bytes if bucketed else 0,
                                 compression.block_size if quantized else 1)
    units = [u.indices for u in units]
    if adasum:
        units = [tuple(range(len(params)))] if params else []
    start = _replicated_reduce(op, compression, prescale_factor,
                               postscale_factor, hierarchical, align, units,
                               layout)
    return _Exchange(params, units, start, overlap=bucketed)


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


def _prepare(model, loss_fn, optimizer, device, remat, op, compression,
             prescale_factor, postscale_factor, sharded_update, bucket_bytes,
             hierarchical):
    """Set-up shared by make_train_step and make_stateful_train_step:
    returns the device, the update (gradient exchange and optimizer step)
    and ``local_loss``."""
    device = basics.resolve_device(device)
    _place(model, device)
    params = [p for p in model.parameters() if p.requires_grad]
    update = _make_update(
        optimizer, params, op, _check_compression(compression),
        prescale_factor, postscale_factor,
        _resolve_hierarchical(hierarchical), sharded_update,
        resolve_bucket_bytes(bucket_bytes))
    return device, update, _make_local_loss(model, loss_fn, remat, device)


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
    its wire dtype; ``hierarchical``, default
    ``HOROVOD_HIERARCHICAL_ALLREDUCE``, in two levels), steps ``optimizer``
    and returns the replica-averaged loss. With a ``seed`` the step calls
    ``loss_fn(model, batch, generator)``, the generator seeded from the
    seed and the replica's index (dropout masks differ across replicas and
    repeat on a rerun). Leaves of ``aux`` are made replica-consistent:
    floating leaves averaged, integer leaves summed. ``remat=True``
    recomputes activations in the backward pass (``torch.utils.checkpoint``,
    non-reentrant).
    ``device=None`` means the device ``init()`` chose (``cuda:local_rank``);
    without CUDA that raises unless ``device="cpu"`` is given. The model is
    moved to the device.

    ``compression=Compression.int8`` reduces through the int8 quantized
    allreduce (about a quarter of the fp32 wire bytes; incompatible with
    ``hierarchical``). ``op=Adasum`` combines the gradients with per-tensor
    Adasum coefficients (power-of-two replica counts; compression and
    buckets do not apply to it). ``bucket_bytes`` (default
    ``HOROVOD_BUCKET_BYTES``, 0 = off) splits the exchange into buckets of
    at most that many bytes in reverse parameter order and launches each
    from the gradient hooks as soon as its gradients are ready, overlapping
    the communication with the rest of the backward; the result equals the
    unbucketed one bit for bit for the plain and 16-bit wire formats, and
    is the same bits for every bound with int8. ``step.exchange.
    early_launches`` counts the units (one per bucket and dtype) launched
    before the last gradient hook of the last step fired.
    ``sharded_update=True`` runs ZeRO-1: ``optimizer`` must come from
    :func:`~horovod_tpu_torch.parallel.zero.sharded_optimizer` with the
    same ``bucket_bytes``; only elementwise optimizers are supported, and
    Adasum and ``hierarchical`` are refused. A parameter that got no
    gradient reduces as zeros on either path, as ``jax.value_and_grad``
    gives it a zero gradient, and the optimizer steps it (weight decay
    and moments included). The int8 wire, and ZeRO-1's shards, follow the
    reference's leaf order and layout where the model's parameters carry
    it (``bucketing.reference_layout``), so the quantization blocks hold
    the reference's elements.
    """
    device, update, local_loss = _prepare(
        model, loss_fn, optimizer, device, remat, op, compression,
        prescale_factor, postscale_factor, sharded_update, bucket_bytes,
        hierarchical)

    @_translated
    def step(batch, seed: Optional[int] = None) -> TrainStepOutput:
        batch = _to_device(batch, device)
        update.zero_grad()
        loss, aux = local_loss(batch, seed)
        update.exchange.begin()
        loss.backward()
        update.step()
        loss = collectives.allreduce(loss.detach(), op=Average, axis=DP_AXES)
        return TrainStepOutput(loss, _sync_aux(aux))

    step.exchange = update.exchange
    # the shared step timer (metrics.timed_step): the elastic driver's
    # scrape diffs its histogram into per-rank step times
    return timed_step(step, framework="torch")


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
    device, update, local_loss = _prepare(
        model, loss_fn, optimizer, device, remat, op, compression,
        prescale_factor, postscale_factor, sharded_update, bucket_bytes,
        hierarchical)

    @_translated
    def step(batch, seed: Optional[int] = None) -> StatefulTrainStepOutput:
        batch = _to_device(batch, device)
        state = {n: b for n, b in model.named_buffers()
                 if b.is_floating_point()}
        update.zero_grad()
        loss, aux = local_loss(batch, seed)
        after_forward = [b.clone() for b in state.values()] if remat else []
        update.exchange.begin()
        loss.backward()
        update.step()
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

    step.exchange = update.exchange
    return timed_step(step, framework="torch")


def make_eval_step(model: nn.Module, apply_fn: Callable,
                   device=None) -> Callable:
    """Forward pass on this replica's slice with no gradient (reference
    dp.py:364-375): ``step(batch)`` returns ``apply_fn(model, batch)`` of
    the whole global batch, gathered over the replica axes in rank
    order."""
    device = basics.resolve_device(device)
    _place(model, device)

    @_translated
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
