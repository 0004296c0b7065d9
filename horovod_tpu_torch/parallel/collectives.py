"""Collectives over the job's replica axes.

Counterpart of ``horovod_tpu/parallel/collectives.py``. The reference
expresses collectives inside a compiled program over named mesh axes; the
port issues ``torch.distributed`` collectives (NCCL on the card, gloo on the
CPU) over the process group of the named replica axes: ``"data"``,
``"fsdp"`` or both, ``("data", "fsdp")``, which is the whole world
(``init()`` creates the groups). The functions are functional, as in the
reference: the input tensor is left unchanged and the result is a new
tensor. Adasum and the int8 quantized collectives are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.reduce_ops import (  # noqa: F401 (re-exported)
    Adasum, Average, Max, Min, Op, Product, Sum,
)
from horovod_tpu_torch.ops.fusion import fused_apply
from horovod_tpu_torch.parallel.mesh import AXIS_ORDER, REPLICA_AXES

DEFAULT_AXIS = "data"

_HALF = (torch.float16, torch.bfloat16)


def _axes(axis) -> tuple:
    """``axis`` as a tuple of replica axes in ``AXIS_ORDER`` order; any
    other axis raises."""
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    bad = [a for a in axes if a not in REPLICA_AXES]
    if bad:
        raise NotImplementedError(
            f"axis {axis!r}: only the replica axes {REPLICA_AXES} are "
            "supported so far; see ROADMAP.md queue A, 'Remaining "
            "parallelism'")
    if not axes or len(set(axes)) != len(axes) or \
            list(axes) != sorted(axes, key=AXIS_ORDER.index):
        raise ValueError(f"axis {axis!r}: name each replica axis once, in "
                         f"the order {REPLICA_AXES}")
    return axes


def _group(axis):
    """(process group or None for the world, its global ranks) of
    ``axis``."""
    return basics.axis_group(_axes(axis))


def _scale(x: torch.Tensor, factor) -> torch.Tensor:
    """Reference ``_scale`` (collectives.py:48-56): integers scale in their
    own dtype, fp16/bf16 through fp32, everything else in place of dtype."""
    if factor is None or factor == 1.0:
        return x
    if not x.is_floating_point():
        return (x * factor).to(x.dtype)
    if x.dtype in _HALF:
        return (x.float() * factor).to(x.dtype)
    return x * factor


def axis_size(axis=DEFAULT_AXIS) -> int:
    """Number of replicas on ``axis``."""
    return len(_group(axis)[1])


def axis_rank(axis=DEFAULT_AXIS) -> int:
    """This replica's index on ``axis`` (row-major over the axes given)."""
    return _group(axis)[1].index(basics.rank())


def allreduce(x: torch.Tensor,
              op: Op = Average,
              axis=DEFAULT_AXIS,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0,
              accumulate_in_fp32: bool = True) -> torch.Tensor:
    """Reduce ``x`` across the replicas of ``axis``. Average is a SUM
    divided by the axis size, as in the reference (collectives.py:108-111);
    Product gathers every replica's ``x`` and multiplies in rank order
    (:116-118). ``accumulate_in_fp32=False`` keeps fp16/bf16 inputs in their
    dtype on the wire, which is the point of 16-bit compression."""
    group, ranks = _group(axis)
    x = _scale(x, prescale_factor)
    if op in (Average, Sum):
        orig_dtype = x.dtype
        if accumulate_in_fp32 and orig_dtype in _HALF:
            out = x.float()
        else:
            out = x.clone()
        dist.all_reduce(out, dist.ReduceOp.SUM, group=group)
        if op is Average:
            out = out / len(ranks)
        out = out.to(orig_dtype)
    elif op in (Min, Max):
        out = x.clone()
        dist.all_reduce(out, dist.ReduceOp.MIN if op is Min
                        else dist.ReduceOp.MAX, group=group)
    elif op is Product:
        # not ReduceOp.PRODUCT, whose order of factors the backend picks
        gathered = _all_gather(x.reshape(1, *x.shape), group, len(ranks))
        out = torch.prod(gathered, dim=0).to(x.dtype)
    elif op is Adasum:
        raise NotImplementedError(
            "Adasum is not ported yet; see ROADMAP.md queue A, 'Remaining "
            "parallelism'")
    else:
        raise ValueError(f"unknown op {op}")
    return _scale(out, postscale_factor)


def grouped_allreduce(xs: Sequence[torch.Tensor],
                      op: Op = Average,
                      axis=DEFAULT_AXIS,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> list:
    """Allreduce a group of tensors as one collective per dtype
    (reference collectives.py:127-153, through ``fused_apply``)."""
    if op is Adasum:
        raise NotImplementedError(
            "Adasum is not ported yet; see ROADMAP.md queue A, 'Remaining "
            "parallelism'")
    fn = functools.partial(allreduce, op=op, axis=axis,
                           prescale_factor=prescale_factor,
                           postscale_factor=postscale_factor)
    return fused_apply(fn, list(xs))


def hierarchical_allreduce(x: torch.Tensor,
                           op: Op = Average,
                           outer_axis="data",
                           inner_axis=("fsdp",),
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0,
                           accumulate_in_fp32: bool = True) -> torch.Tensor:
    """Two-level allreduce (reference collectives.py:156-215):
    reduce-scatter over the fast ``inner_axis``, allreduce the 1/inner
    shard over ``outer_axis``, all-gather over ``inner_axis``. The flat
    tensor is zero-padded to a multiple of the inner size. Min, Max and
    Product have no reduce-scatter form and take the flat allreduce over
    both axes."""
    outer, inner = _axes(outer_axis), _axes(inner_axis)
    both = tuple(sorted(outer + inner, key=AXIS_ORDER.index))
    if op not in (Average, Sum):
        return allreduce(x, op=op, axis=both,
                         prescale_factor=prescale_factor,
                         postscale_factor=postscale_factor,
                         accumulate_in_fp32=accumulate_in_fp32)
    inner_group, inner_ranks = _group(inner)
    outer_group, outer_ranks = _group(outer)
    x = _scale(x, prescale_factor)
    orig_dtype, orig_shape = x.dtype, x.shape
    if accumulate_in_fp32 and orig_dtype in _HALF:
        x = x.float()
    n_inner = len(inner_ranks)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n_inner
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = flat.new_empty(flat.numel() // n_inner)
    dist.reduce_scatter_tensor(shard, flat.contiguous(), dist.ReduceOp.SUM,
                               group=inner_group)
    dist.all_reduce(shard, dist.ReduceOp.SUM, group=outer_group)
    out = _all_gather(shard, inner_group, n_inner)
    if pad:
        out = out[:flat.numel() - pad]
    out = out.reshape(orig_shape)
    if op is Average:
        out = out / (len(outer_ranks) * n_inner)
    return _scale(out.to(orig_dtype), postscale_factor)


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every replica's ``x`` concatenated along dim 0, in rank order."""
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def allgather(x: torch.Tensor, axis=DEFAULT_AXIS) -> torch.Tensor:
    """Concatenate ``x`` from every replica along dim 0, in rank order
    (reference collectives.py:218-230; equal shapes)."""
    group, ranks = _group(axis)
    return _all_gather(x, group, len(ranks))


def broadcast(x: torch.Tensor, root_rank: int = 0,
              axis=DEFAULT_AXIS) -> torch.Tensor:
    """``x`` as held by the replica with index ``root_rank`` on ``axis``,
    on every replica of the axis."""
    group, ranks = _group(axis)
    out = x.detach().clone()
    dist.broadcast(out, src=ranks[root_rank], group=group)
    return out


def alltoall(x: torch.Tensor,
             axis=DEFAULT_AXIS,
             split_axis: int = 0,
             concat_axis: int = 0) -> torch.Tensor:
    """Split ``x`` into equal slices along ``split_axis``, send slice i to
    replica i, and concatenate the slices received along ``concat_axis`` in
    rank order (reference collectives.py:248-258, ``tiled=True``)."""
    group, ranks = _group(axis)
    n = len(ranks)
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % n:
        raise ValueError(f"alltoall: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split into {n} slices")
    send = x.movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    pieces = recv.reshape(n, send.shape[0] // n, *send.shape[1:])
    return torch.cat([p.movedim(0, split_axis) for p in pieces],
                     dim=concat_axis)


def reducescatter(x: torch.Tensor, op: Op = Average,
                  axis=DEFAULT_AXIS) -> torch.Tensor:
    """Reduce over the replicas and keep this replica's slice of dim 0
    (reference collectives.py:261-273): Sum, or Average, which divides in
    fp32 and casts back."""
    if op not in (Average, Sum):
        raise ValueError(f"reducescatter supports Sum/Average, got {op}")
    group, ranks = _group(axis)
    n = len(ranks)
    if x.shape[0] % n:
        raise ValueError(f"reducescatter: dim 0 of {tuple(x.shape)} does "
                         f"not split into {n} slices")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), dist.ReduceOp.SUM,
                               group=group)
    if op is Average:
        out = (out.float() / n).to(x.dtype)
    return out


def barrier(axis=DEFAULT_AXIS) -> None:
    """Wait until every replica of ``axis`` has reached this point
    (reference collectives.py:359-363)."""
    dist.barrier(group=_group(axis)[0])


def ppermute(x: torch.Tensor, perm, axis=DEFAULT_AXIS) -> torch.Tensor:
    """Send ``x`` along the ``(src, dst)`` pairs of ``perm`` (replica
    indices on ``axis``) and return what this replica received; a replica
    that no pair sends to receives zeros, as ``lax.ppermute`` gives
    (reference collectives.py:366-369)."""
    group, ranks = _group(axis)
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    n = len(ranks)
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
            any(not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: {perm} is not a partial permutation "
                         f"of {n} replicas")
    me = ranks.index(basics.rank())
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x, ranks[d], group=group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group=group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out
