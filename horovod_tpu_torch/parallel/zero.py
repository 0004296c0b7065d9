"""Cross-replica sharded weight update: ZeRO stage 1 for the DP step.

Counterpart of ``horovod_tpu/parallel/zero.py:45-280, 567-609`` (Xu et al.,
arXiv:2004.13336). Instead of allreducing the whole gradient and running
the same optimizer update on every replica, the step

    reduce-scatters the gradients -> updates this replica's 1/N shard of
    the parameters and optimizer state -> all-gathers the updates -> adds
    them to the replicated parameters.

Optimizer state and update work shrink to 1/N per replica; with fp32 the
wire bytes equal an allreduce's, and the int8 quantized collectives cut
them about 4x on both phases.

Layout: parameters group per dtype (first-seen order, as ``ops/fusion.py``
fuses), or per (bucket, dtype) with a bucket bound (every tensor then
padded to whole ``block_size`` blocks, ``parallel/bucketing.py``), each
group flattened, zero-padded to a multiple of ``N * block_size`` and split
contiguously over the replicas. Where the model's parameters carry the
reference's leaf order and layout (``bucketing.reference_layout``), the
groups follow it, so the shards and the int8 blocks hold the reference's
elements. ``torch.optim`` needs tensors, not a
pytree: :func:`sharded_optimizer` (the counterpart of ``sharded_opt_init``)
builds the optimizer over one flat shard tensor per group, and
``make_train_step(..., sharded_update=True)`` takes that object.

What crosses the wire in the second phase is the update (new shard - old
shard), as in the reference (zero.py:214-232): on a lossy wire (fp16, bf16,
int8) the parameters themselves would be corrupted by the round trip. The
shard is reloaded from the replicated parameters before every update.

Only elementwise optimizers (SGD, momentum, Adam, AdamW, RMSprop, ...) are
supported: a transform that couples elements across the tensor, such as
clipping by the global norm, would see only the local shard. At world 1 the
shard is the whole group: no memory is saved. The elastic reshard half of
the reference's module (zero.py:283-565) waits for ROADMAP queue A item 8.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.parallel.bucketing import (Layout, fuse,
                                                  plan_units_in,
                                                  reference_layout,
                                                  resolve_bucket_bytes,
                                                  unfuse)
from horovod_tpu_torch.parallel.collectives import Average, Op, Pending, Sum
from horovod_tpu_torch.parallel.mesh import REPLICA_AXES

# Flat groups are padded to a multiple of axis_size * LANE whether or not
# the int8 path (which quantizes LANE-sized blocks) is on.
LANE = 256


class _DtypeGroup(NamedTuple):
    key: str                  # e.g. "float32", "b0003/float32"
    dtype: torch.dtype
    indices: Tuple[int, ...]  # tensor positions
    sizes: Tuple[int, ...]    # element counts
    shapes: Tuple[torch.Size, ...]
    padded: int               # flat length after zero-padding
    shard: int                # padded // n_shards


def plan_groups(leaves: Sequence[torch.Tensor], n_shards: int,
                bucket_bytes: int, block_size: int = LANE,
                layout: Optional[Layout] = None
                ) -> Tuple[Tuple[_DtypeGroup, ...], int]:
    """``(groups, leaf_align)``: the units of ``bucketing.plan_units`` (in
    ``layout``'s order, shapes in its layout) with the shard geometry on
    top, each group's flat length padded to a multiple of ``n_shards *
    block_size`` (reference ``_group_leaves`` and ``bucket_groups``,
    zero.py:61-104)."""
    layout = layout or Layout.plain(len(leaves))
    units, leaf_align = plan_units_in(layout, leaves, bucket_bytes,
                                      block_size)
    lane = n_shards * block_size
    groups = []
    for unit in units:
        sizes = tuple(leaves[i].numel() for i in unit.indices)
        total = sum(sz + (-sz) % leaf_align for sz in sizes)
        padded = total + (-total) % lane
        groups.append(_DtypeGroup(
            key=unit.key, dtype=unit.dtype, indices=unit.indices,
            sizes=sizes, shapes=tuple(layout.to_ref(i, leaves[i]).shape
                                      for i in unit.indices),
            padded=padded, shard=padded // n_shards))
    return tuple(groups), leaf_align


def _local_pieces(group: _DtypeGroup, rank: int, leaf_align: int) -> list:
    """``(tensor position, start, stop, shard offset)`` of every piece of a
    tensor that falls into ``rank``'s shard of ``group``."""
    lo, hi = rank * group.shard, (rank + 1) * group.shard
    pieces, offset = [], 0
    for i, n in zip(group.indices, group.sizes):
        a, b = max(offset, lo), min(offset + n, hi)
        if a < b:
            pieces.append((i, a - offset, b - offset, a - lo))
        offset += n + (-n) % leaf_align
    return pieces


class ShardedOptimizer:
    """A ``torch.optim`` optimizer over this replica's flat shards of the
    model's trainable parameters, with the layout the sharded step needs.
    Built by :func:`sharded_optimizer`; ``optimizer`` is the torch
    optimizer, ``shards`` its parameters (one per group), ``params`` the
    model's trainable parameters."""

    def __init__(self, params: List[nn.Parameter],
                 make_optimizer: Callable[[List[torch.Tensor]],
                                          torch.optim.Optimizer],
                 axes, bucket_bytes: int, block_size: int):
        self.params, self.axes = params, axes
        self.bucket_bytes, self.block_size = bucket_bytes, block_size
        self.n_shards = collectives.axis_size(axes)
        rank = collectives.axis_rank(axes)
        self.layout = reference_layout(params)
        self.groups, self.leaf_align = plan_groups(
            params, self.n_shards, bucket_bytes, block_size, self.layout)
        self._pieces = [_local_pieces(g, rank, self.leaf_align)
                        for g in self.groups]
        device = params[0].device if params else basics.device()
        self.shards = [torch.zeros(g.shard, dtype=g.dtype, device=device)
                       for g in self.groups]
        self.load_shards()
        self.optimizer = make_optimizer(self.shards)

    @torch.no_grad()
    def load_shards(self) -> None:
        """Copy this replica's slice of the parameters, in the groups'
        layout, into the shards."""
        for shard, pieces in zip(self.shards, self._pieces):
            for i, a, b, s in pieces:
                src = self.layout.to_ref(i, self.params[i]).reshape(-1)
                shard[s:s + b - a].copy_(src[a:b])

    def state_bytes(self) -> int:
        """Bytes of optimizer state this replica holds."""
        return sum(v.numel() * v.element_size()
                   for st in self.optimizer.state.values()
                   for v in st.values() if isinstance(v, torch.Tensor))


def sharded_optimizer(model: nn.Module,
                      make_optimizer: Callable[[List[torch.Tensor]],
                                               torch.optim.Optimizer],
                      *, bucket_bytes: Optional[int] = None,
                      block_size: int = LANE,
                      axes=REPLICA_AXES) -> ShardedOptimizer:
    """The ZeRO-1 optimizer of ``model`` (the counterpart of the reference's
    ``sharded_opt_init``, zero.py:255-280): ``make_optimizer(shards)``
    builds a torch optimizer, e.g. ``lambda ps: torch.optim.AdamW(ps,
    lr=1e-4)``, over this replica's flat shards, each ``1/N`` of a group.
    Call after ``init()``; the model moves to ``init()``'s device.
    ``bucket_bytes`` (default ``HOROVOD_BUCKET_BYTES``) must be the train
    step's: the layout is a function of it."""
    model.to(basics.device())
    params = [p for p in model.parameters() if p.requires_grad]
    return ShardedOptimizer(params, make_optimizer,
                            collectives._axes(axes),
                            resolve_bucket_bytes(bucket_bytes), block_size)


def check_op(op: Op) -> None:
    if op not in (Average, Sum):
        raise ValueError(
            f"sharded_update supports Sum/Average gradient reduction, got "
            f"{op} — Adasum/Min/Max/Product have no reduce-scatter form")


def reduce_scatter_grads(sopt: ShardedOptimizer, index: int,
                         grads: Sequence[torch.Tensor], *,
                         op: Op = Average, compression=None,
                         prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0) -> Pending:
    """Phase 1 for group ``index``: its gradients (``grads``, in the
    group's order) flattened and reduce-scattered over the replicas, int8
    or in the compressor's wire dtype. Returns a :class:`Pending` of this
    replica's shard of the reduced gradient."""
    group = sopt.groups[index]
    flat = fuse([sopt.layout.to_ref(i, g)
                 for i, g in zip(group.indices, grads)],
                sopt.leaf_align, group.padded)
    flat = collectives._scale(flat, prescale_factor)
    if getattr(compression, "quantized", False):
        pending = collectives.quantized_reducescatter(
            flat, op=op, axis=sopt.axes, block_size=sopt.block_size,
            async_op=True).then(lambda s: s.to(group.dtype))
    elif compression is not None:
        wire, ctx = compression.compress(flat)
        pending = collectives.reducescatter(
            wire, op=op, axis=sopt.axes, async_op=True).then(
                lambda s: compression.decompress(s, ctx))
    else:
        pending = collectives.reducescatter(flat, op=op, axis=sopt.axes,
                                            async_op=True)
    return pending.then(
        lambda s: collectives._scale(s, postscale_factor))


@torch.no_grad()
def apply_sharded_update(sopt: ShardedOptimizer,
                         shard_grads: Sequence[torch.Tensor],
                         compression=None) -> None:
    """Phase 2: step the optimizer on the shards with ``shard_grads`` (one
    per group, from :func:`reduce_scatter_grads`), all-gather each shard's
    update (int8 or in the compressor's wire dtype) and add it to the
    replicated parameters in place (reference zero.py:210-234)."""
    sopt.load_shards()
    before = [s.clone() for s in sopt.shards]
    for shard, grad in zip(sopt.shards, shard_grads):
        shard.grad = grad
    sopt.optimizer.step()
    quantized = getattr(compression, "quantized", False)
    for group, shard, old in zip(sopt.groups, sopt.shards, before):
        update = shard - old
        shard.grad = None
        if quantized:
            full = collectives.quantized_allgather(
                update, axis=sopt.axes,
                block_size=sopt.block_size).to(group.dtype)
        elif compression is not None:
            wire, ctx = compression.compress(update)
            full = compression.decompress(
                collectives.allgather(wire, axis=sopt.axes), ctx)
        else:
            full = collectives.allgather(update, axis=sopt.axes)
        for i, u in zip(group.indices,
                        unfuse(full, group.shapes, sopt.leaf_align)):
            sopt.params[i].add_(sopt.layout.from_ref(i, u))


def optimizer_state_bytes(params: Sequence[torch.Tensor], n_shards: int,
                          state_factor: float = 2.0,
                          block_size: int = LANE) -> dict:
    """Replicated against sharded optimizer-state bytes per replica
    (reference zero.py:567-580); ``state_factor`` is state values per
    parameter (2 for Adam's two moments, 1 for momentum)."""
    params = list(params)
    total = sum(p.numel() * p.element_size() for p in params)
    padded = sum(g.padded * torch.empty((), dtype=g.dtype).element_size()
                 for g in plan_groups(params, n_shards, 0, block_size)[0])
    return {"replicated": int(total * state_factor),
            "sharded": int(padded * state_factor / n_shards)}


def collective_bytes_per_step(n_params: int, n_shards: int, *,
                              mode: str = "allreduce",
                              wire_bytes_per_elem: float = 4.0,
                              block_size: int = LANE,
                              scale_bytes: float = 4.0) -> int:
    """Ring-cost wire bytes each replica moves per step for the gradient
    exchange (reference zero.py:583-609): ``2 (N-1)/N`` of the payload for
    either mode; an int8 payload (``wire_bytes_per_elem == 1``) carries one
    fp32 scale per ``block_size`` elements."""
    if mode not in ("allreduce", "sharded"):
        raise ValueError(f"unknown mode {mode!r}")
    ring = 2.0 * (n_shards - 1) / max(n_shards, 1)
    payload = n_params * wire_bytes_per_elem
    if wire_bytes_per_elem == 1.0:
        payload += n_params / block_size * scale_bytes
    return int(ring * payload)
