"""Collectives over the job's mesh axes.

Counterpart of ``horovod_tpu/parallel/collectives.py``. The reference
expresses collectives inside a compiled program over named mesh axes; the
port issues ``torch.distributed`` collectives (NCCL on the card, gloo on the
CPU) over the process group of the named axes: any of ``AXIS_ORDER``
(``"data"``, ``"fsdp"``, ``"model"``, ``"seq"``, ``"pipe"``,
``"expert"``), or a tuple of them in any order (``init()`` creates the
groups). Over an axis of size 1 each collective returns its one replica's
value, as ``lax`` does. A tuple indexes the replicas row-major in the
order it names the axes, as ``lax.axis_index`` of a tuple does: the
gathers, exchanges, scatters, ``broadcast``'s root and ``axis_rank`` follow
that order (``ppermute``, like ``lax.ppermute``, keeps the mesh's order).
The functions are functional, as in the reference: the input tensor is
left unchanged and the result is a new tensor. Each runs inside
``profiler.annotate.collective_scope`` under the reference's name
(``hvd_allreduce_sum``, ``hvd_alltoall``, ...).

JAX differentiates through ``lax.ppermute`` and ``lax.all_to_all`` for
free; a ``torch.distributed`` call records nothing for autograd, so a
gradient through it would be silently zero. :func:`ppermute` and
:func:`alltoall` are therefore ``torch.autograd.Function``s: the backward
of a permutation is the inverse permutation, that of an all-to-all the
all-to-all with ``split_axis`` and ``concat_axis`` swapped. Every rank
must run the backward, as every rank ran the forward.

``allreduce``, ``hierarchical_allreduce``, ``reducescatter`` and the int8
``quantized_reducescatter``/``quantized_allreduce`` take ``async_op=True``:
they then issue their first communication and return a :class:`Pending`,
whose ``wait()`` finishes the collective: the bucketed gradient exchange
of ``parallel/dp.py`` launches buckets that way while the backward still
runs.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.reduce_ops import (  # noqa: F401 (re-exported)
    Adasum, Average, Max, Min, Op, Product, Sum,
)
from horovod_tpu_torch.compression import (block_dequantize_rows,
                                           block_quantize_rows)
from horovod_tpu_torch.ops.fusion import fused_apply
from horovod_tpu_torch.parallel.mesh import AXIS_ORDER
from horovod_tpu_torch.profiler.annotate import collective_scope

DEFAULT_AXIS = "data"

_HALF = (torch.float16, torch.bfloat16)


class Pending:
    """A collective in flight (``async_op=True``). The communication has
    been issued; ``wait()`` waits for it, finishes the computation and
    returns the result. It holds every buffer the communication reads or
    writes (``keep``, and what ``finish`` reads) until then: on NCCL the
    caching allocator must not hand a buffer on while the card still
    reads it."""

    def __init__(self, works: Sequence, finish: Callable[[], torch.Tensor],
                 keep: Sequence[torch.Tensor] = ()):
        self._works, self._finish = list(works), finish
        self._keep = tuple(keep)

    def wait(self):
        """The result; a backend failure raises ``HorovodInternalError``
        (``basics.translate_failures``), and in an elastic job each wait
        is bounded (``basics.wait_work``)."""
        with basics.translate_failures():
            for work in self._works:
                basics.wait_work(work)
            out = self._finish()
        self._keep = ()
        return out

    def then(self, fn: Callable) -> "Pending":
        """A Pending of ``fn`` applied to this one's result."""
        return Pending(self._works, lambda: fn(self._finish()), self._keep)


def _complete(works, finish, async_op: bool, keep=()):
    pending = Pending(works, finish, keep)
    return pending if async_op else pending.wait()


def _axes(axis) -> tuple:
    """``axis`` as a tuple of mesh axes, each named once, in the order
    given; a name outside ``AXIS_ORDER`` raises."""
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    bad = [a for a in axes if a not in AXIS_ORDER]
    if bad:
        raise ValueError(f"axis {axis!r}: {bad} not among the mesh axes "
                         f"{AXIS_ORDER}")
    if not axes or len(set(axes)) != len(axes):
        raise ValueError(f"axis {axis!r}: name each mesh axis once")
    return axes


def _scoped(prefix: str, ops: Optional[tuple] = None):
    """Run the decorated collective inside ``collective_scope(prefix)``,
    or, with ``ops``, ``prefix_{op}`` when its ``op`` (the second
    argument, Average by default) is one of ``ops``, and unnamed
    otherwise (where the reference hands the op to another collective)."""
    def wrap(fn):
        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            name = prefix
            if ops is not None:
                op = args[1] if len(args) > 1 else kwargs.get("op", Average)
                if op not in ops:
                    return fn(*args, **kwargs)
                name = f"{prefix}_{op.value}"
            with collective_scope(name):
                return fn(*args, **kwargs)
        return scoped
    return wrap


_ALL_OPS = (Average, Sum, Adasum, Min, Max, Product)


def _group(axis):
    """(process group or None for the world, its global ranks in axis index
    order) of ``axis``."""
    return basics.axis_group(_axes(axis))


def _quantized_group(axis):
    """:func:`_group` for the quantized ops, which also take ``axis=None``:
    this process alone, a world of one with no group (and no ``init()``),
    where the codec still makes its round trips and nothing is sent."""
    return (None, [None]) if axis is None else _group(axis)


def _group_order(ranks: List[int]) -> Optional[List[int]]:
    """Position in its process group (ascending global ranks) of each axis
    index's rank; None where the two orders agree."""
    order = sorted(ranks)
    pos = [order.index(r) for r in ranks]
    return None if pos == list(range(len(ranks))) else pos


def _to_group_order(chunks: torch.Tensor, pos) -> torch.Tensor:
    """``chunks`` [n, ...] in axis index order, reordered so that chunk i
    sits at its rank's group position ``pos[i]``."""
    if pos is None:
        return chunks.contiguous()
    inverse = [0] * len(pos)
    for i, p in enumerate(pos):
        inverse[p] = i
    return chunks[inverse].contiguous()


def _to_index_order(chunks: torch.Tensor, pos) -> torch.Tensor:
    """``chunks`` [n, ...] in group order, reordered to axis index order."""
    return chunks if pos is None else chunks[pos]


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


@_scoped("hvd_allreduce", _ALL_OPS)
def allreduce(x: torch.Tensor,
              op: Op = Average,
              axis=DEFAULT_AXIS,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0,
              accumulate_in_fp32: bool = True,
              async_op: bool = False):
    """Reduce ``x`` across the replicas of ``axis``. Average is a SUM
    divided by the axis size, as in the reference (collectives.py:108-111);
    Product gathers every replica's ``x`` and multiplies in axis order
    (:116-118); Adasum combines pairwise with per-tensor coefficients
    (``parallel/adasum.py``). ``accumulate_in_fp32=False`` keeps fp16/bf16
    inputs in their dtype on the wire, which is the point of 16-bit
    compression. ``async_op=True`` returns a :class:`Pending`."""
    group, ranks = _group(axis)
    x = _scale(x, prescale_factor)
    works = []
    if op in (Average, Sum):
        orig_dtype = x.dtype
        if accumulate_in_fp32 and orig_dtype in _HALF:
            buf = x.float()
        else:
            buf = x.clone()
        works.append(dist.all_reduce(buf, dist.ReduceOp.SUM, group=group,
                                     async_op=True))

        def finish():
            out = buf / len(ranks) if op is Average else buf
            return _scale(out.to(orig_dtype), postscale_factor)
    elif op in (Min, Max):
        buf = x.clone()
        works.append(dist.all_reduce(
            buf, dist.ReduceOp.MIN if op is Min else dist.ReduceOp.MAX,
            group=group, async_op=True))

        def finish():
            return _scale(buf, postscale_factor)
    elif op is Product:
        # not ReduceOp.PRODUCT, whose order of factors the backend picks
        gathered = _all_gather(x.reshape(1, *x.shape), group, len(ranks),
                               _group_order(ranks))
        out = _scale(torch.prod(gathered, dim=0).to(x.dtype),
                     postscale_factor)

        def finish():
            return out
    elif op is Adasum:
        from horovod_tpu_torch.parallel.adasum import adasum_allreduce
        out = _scale(adasum_allreduce(x, axis), postscale_factor)

        def finish():
            return out
    else:
        raise ValueError(f"unknown op {op}")
    return _complete(works, finish, async_op)


def grouped_allreduce(xs: Sequence[torch.Tensor],
                      op: Op = Average,
                      axis=DEFAULT_AXIS,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> list:
    """Allreduce a group of tensors as one collective per dtype
    (reference collectives.py:127-153, through ``fused_apply``). Adasum is
    not elementwise: it runs one fused pass that keeps per-tensor
    coefficients (``adasum_allreduce_group``)."""
    xs = list(xs)
    if op is Adasum:
        from horovod_tpu_torch.parallel.adasum import adasum_allreduce_group
        outs = adasum_allreduce_group(
            [_scale(x, prescale_factor) for x in xs], axis)
        return [_scale(o, postscale_factor) for o in outs]
    fn = functools.partial(allreduce, op=op, axis=axis,
                           prescale_factor=prescale_factor,
                           postscale_factor=postscale_factor)
    return fused_apply(fn, xs)


@_scoped("hvd_hierarchical_allreduce", (Average, Sum))
def hierarchical_allreduce(x: torch.Tensor,
                           op: Op = Average,
                           outer_axis="data",
                           inner_axis=("fsdp",),
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0,
                           accumulate_in_fp32: bool = True,
                           async_op: bool = False):
    """Two-level allreduce (reference collectives.py:156-215):
    reduce-scatter over the fast ``inner_axis``, allreduce the 1/inner
    shard over ``outer_axis``, all-gather over ``inner_axis``. The flat
    tensor is zero-padded to a multiple of the inner size. Min, Max and
    Product have no reduce-scatter form and take the flat allreduce over
    both axes. ``async_op=True`` returns a :class:`Pending` once the
    reduce-scatter is issued."""
    outer, inner = _axes(outer_axis), _axes(inner_axis)
    if op not in (Average, Sum):
        return allreduce(x, op=op, axis=outer + inner,
                         prescale_factor=prescale_factor,
                         postscale_factor=postscale_factor,
                         accumulate_in_fp32=accumulate_in_fp32,
                         async_op=async_op)
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
    flat = flat.contiguous()
    shard = flat.new_empty(flat.numel() // n_inner)
    work = dist.reduce_scatter_tensor(shard, flat, dist.ReduceOp.SUM,
                                      group=inner_group, async_op=True)

    def finish():
        dist.all_reduce(shard, dist.ReduceOp.SUM, group=outer_group)
        # the gather undoes the scatter in the group's own order
        out = _all_gather(shard, inner_group, n_inner)
        if pad:
            out = out[:flat.numel() - pad]
        out = out.reshape(orig_shape)
        if op is Average:
            out = out / (len(outer_ranks) * n_inner)
        return _scale(out.to(orig_dtype), postscale_factor)
    return _complete([work], finish, async_op, keep=(flat,))


def _all_gather(x: torch.Tensor, group, n: int, pos=None) -> torch.Tensor:
    """Every replica's ``x`` concatenated along dim 0: in group order, or
    in axis index order given the group positions ``pos``."""
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    Pending([dist.all_gather_into_tensor(out, x, group=group,
                                         async_op=True)],
            lambda: out, keep=(x,)).wait()
    if pos is None:
        return out
    return _to_index_order(out.reshape(n, *x.shape), pos).reshape(out.shape)


@_scoped("hvd_allgather")
def allgather(x: torch.Tensor, axis=DEFAULT_AXIS) -> torch.Tensor:
    """Concatenate ``x`` from every replica along dim 0, in axis order
    (reference collectives.py:218-230; equal shapes)."""
    group, ranks = _group(axis)
    return _all_gather(x, group, len(ranks), _group_order(ranks))


@_scoped("hvd_broadcast")
def broadcast(x: torch.Tensor, root_rank: int = 0,
              axis=DEFAULT_AXIS) -> torch.Tensor:
    """``x`` as held by the replica with index ``root_rank`` on ``axis``,
    on every replica of the axis."""
    group, ranks = _group(axis)
    out = x.detach().clone()
    dist.broadcast(out, src=ranks[root_rank], group=group)
    return out


@_scoped("hvd_alltoall")
def alltoall(x: torch.Tensor,
             axis=DEFAULT_AXIS,
             split_axis: int = 0,
             concat_axis: int = 0) -> torch.Tensor:
    """Split ``x`` into equal slices along ``split_axis``, send slice i to
    replica i, and concatenate the slices received along ``concat_axis`` in
    axis order (reference collectives.py:248-258, ``tiled=True``).
    Differentiable: the gradient goes back by the swapped all-to-all."""
    return _AllToAll.apply(x, axis, split_axis, concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        ctx.args = (axis, concat_axis, split_axis)
        return _alltoall(x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        with collective_scope("hvd_alltoall"):
            return _alltoall(g, *ctx.args), None, None, None


def _alltoall(x, axis, split_axis, concat_axis):
    group, ranks = _group(axis)
    n = len(ranks)
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % n:
        raise ValueError(f"alltoall: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split into {n} slices")
    pos = _group_order(ranks)
    send = x.movedim(split_axis, 0)
    chunk_shape = (n, send.shape[0] // n, *send.shape[1:])
    send = _to_group_order(send.reshape(chunk_shape), pos)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    pieces = _to_index_order(recv, pos)
    return torch.cat([p.movedim(0, split_axis) for p in pieces],
                     dim=concat_axis)


@_scoped("hvd_reducescatter", _ALL_OPS)
def reducescatter(x: torch.Tensor, op: Op = Average,
                  axis=DEFAULT_AXIS, async_op: bool = False):
    """Reduce over the replicas and keep this replica's slice of dim 0
    (reference collectives.py:261-273): Sum, or Average, which divides in
    fp32 and casts back. ``async_op=True`` returns a :class:`Pending`."""
    if op not in (Average, Sum):
        raise ValueError(f"reducescatter supports Sum/Average, got {op}")
    group, ranks = _group(axis)
    n = len(ranks)
    if x.shape[0] % n:
        raise ValueError(f"reducescatter: dim 0 of {tuple(x.shape)} does "
                         f"not split into {n} slices")
    per = x.shape[0] // n
    send = _to_group_order(x.reshape(n, per, *x.shape[1:]),
                           _group_order(ranks)).reshape(x.shape)
    out = x.new_empty((per, *x.shape[1:]))
    work = dist.reduce_scatter_tensor(out, send, dist.ReduceOp.SUM,
                                      group=group, async_op=True)

    def finish():
        if op is Average:
            return (out.float() / n).to(x.dtype)
        return out
    return _complete([work], finish, async_op, keep=(send,))


@_scoped("hvd_quantized_reducescatter", _ALL_OPS)
def quantized_reducescatter(x: torch.Tensor,
                            op: Op = Average,
                            axis=DEFAULT_AXIS,
                            block_size: int = 256,
                            async_op: bool = False):
    """Reduce-scatter with an int8 wire format (reference
    collectives.py:276-308, EQuARX). ``x`` is 1-D with ``x.numel() %
    (axis_size * block_size) == 0``. Each replica block-quantizes its n
    rows and exchanges them with one int8 ``all_to_all`` plus one of the
    fp32 scales (one per block); it then dequantizes the rows it received
    and sums them in fp32, in axis order. Returns this replica's fp32
    shard of ``x.numel() / axis_size`` elements."""
    if op not in (Average, Sum):
        raise ValueError(f"quantized_reducescatter supports Sum/Average, "
                         f"got {op}")
    group, ranks = _quantized_group(axis)
    n = len(ranks)
    pos = _group_order(ranks)
    payload, scales = block_quantize_rows(x.reshape(n, -1), block_size)
    if axis is None:  # a world of one: the one row stays here
        payload_in, scales_in, works = payload, scales, []
    else:
        # row d goes to replica d; replica s's row for us arrives as row s
        payload, scales = (_to_group_order(t, pos)
                           for t in (payload, scales))
        payload_in, scales_in = torch.empty_like(payload), \
            torch.empty_like(scales)
        works = [dist.all_to_all_single(payload_in, payload, group=group,
                                        async_op=True),
                 dist.all_to_all_single(scales_in, scales, group=group,
                                        async_op=True)]

    def finish():
        rows = block_dequantize_rows(_to_index_order(payload_in, pos),
                                     _to_index_order(scales_in, pos),
                                     block_size)
        out = rows[0].clone()
        for row in rows[1:]:
            out += row
        return out / n if op is Average else out
    return _complete(works, finish, async_op,
                     keep=(payload, scales))


@_scoped("hvd_quantized_allgather")
def quantized_allgather(x: torch.Tensor,
                        axis=DEFAULT_AXIS,
                        block_size: int = 256) -> torch.Tensor:
    """All-gather a 1-D shard (``x.numel() % block_size == 0``) as int8
    blocks and fp32 scales; returns the fp32 concatenation in axis order
    (reference collectives.py:311-326)."""
    group, ranks = _quantized_group(axis)
    n, pos = len(ranks), _group_order(ranks)
    payload, scales = block_quantize_rows(x.reshape(1, -1), block_size)
    if axis is not None:
        payload = _all_gather(payload, group, n, pos)
        scales = _all_gather(scales, group, n, pos)
    return block_dequantize_rows(payload, scales, block_size).reshape(-1)


def quantized_allreduce(x: torch.Tensor,
                        op: Op = Average,
                        axis=DEFAULT_AXIS,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        block_size: int = 256,
                        async_op: bool = False):
    """Allreduce with int8 on the wire both ways (reference
    collectives.py:329-356): the quantized reduce-scatter, then the
    quantized all-gather of the reduced shards. ``x`` is zero-padded to a
    multiple of ``axis_size * block_size``. Two quantization round trips:
    each element is within about max|block|/127 of the exact result, and
    every replica gets the same numbers. ``axis=None`` is a world of one
    with no group: the two round trips, nothing sent. ``async_op=True``
    returns a :class:`Pending` once the reduce-scatter is issued."""
    if op not in (Average, Sum):
        raise ValueError(f"quantized_allreduce supports Sum/Average, got {op}")
    x = _scale(x, prescale_factor)
    orig_dtype, orig_shape = x.dtype, x.shape
    n = len(_quantized_group(axis)[1])
    flat = x.reshape(-1)
    size = flat.numel()
    pad = (-size) % (n * block_size)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])

    def gather(shard):
        out = quantized_allgather(shard, axis=axis, block_size=block_size)
        out = out[:size].reshape(orig_shape).to(orig_dtype)
        return _scale(out, postscale_factor)
    pending = quantized_reducescatter(flat, op=op, axis=axis,
                                      block_size=block_size,
                                      async_op=True).then(gather)
    return pending if async_op else pending.wait()


def barrier(axis=DEFAULT_AXIS) -> None:
    """Wait until every replica of ``axis`` has reached this point
    (reference collectives.py:359-363)."""
    dist.barrier(group=_group(axis)[0])


def ppermute(x: torch.Tensor, perm, axis=DEFAULT_AXIS) -> torch.Tensor:
    """Send ``x`` along the ``(src, dst)`` pairs of ``perm`` (replica
    indices on ``axis``) and return what this replica received; a replica
    that no pair sends to receives zeros, as ``lax.ppermute`` gives
    (reference collectives.py:366-369). Unlike ``axis_rank``,
    ``lax.ppermute`` numbers the replicas of a tuple in the mesh's own
    axis order (data before fsdp) whatever order the tuple names, and so
    does this. Differentiable: the gradient goes back along the inverse
    permutation."""
    perm = [(int(s), int(d)) for s, d in perm]
    return _PPermute.apply(x, perm, axis)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, axis):
        ctx.args = ([(d, s) for s, d in perm], axis)
        return _ppermute(x, perm, axis)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, *ctx.args), None, None


def _ppermute(x: torch.Tensor, perm, axis) -> torch.Tensor:
    group, ranks = _group(sorted(_axes(axis), key=AXIS_ORDER.index))
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
