"""Eager collective ops on device tensors.

Counterpart of ``horovod_tpu/jax/mpi_ops.py``: the sync ops, their
``_async`` forms, ``synchronize``, ``poll``, ``barrier`` and ``join``. The
ops are negotiated by name (``common/eager.py``), so ranks may call them in
different orders. With ``axis=`` a sync op runs instead as the in-step
collective of ``parallel/collectives.py`` over that replica axis, the
counterpart of the reference's traced branch; every rank must then call it
in the same order.
"""

from __future__ import annotations

from horovod_tpu_torch.common.eager import (  # noqa: F401 (re-exported)
    Handle, HorovodInternalError, LocalHandle, allgather_async,
    allreduce_async, alltoall_async, barrier, broadcast_async,
    grouped_allreduce_async, join, poll, resolve_op, synchronize,
)
from horovod_tpu_torch.common.reduce_ops import (  # noqa: F401
    Adasum, Average, Max, Min, Op, Product, Sum,
)
from horovod_tpu_torch.parallel import collectives


def allreduce(tensor, average=None, name=None, op=None, prescale_factor=1.0,
              postscale_factor=1.0, axis=None):
    """``tensor`` reduced over every rank (``op``, default Average; the
    legacy ``average=`` picks Average or Sum), scaled before and after."""
    if axis is not None:
        return collectives.allreduce(
            tensor, op=resolve_op(op, average), axis=axis,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor)
    return synchronize(allreduce_async(tensor, average, name, op,
                                       prescale_factor, postscale_factor))


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0, axis=None):
    """:func:`allreduce` of every tensor of ``tensors``, negotiated as one
    group and fused per dtype."""
    if axis is not None:
        return collectives.grouped_allreduce(
            tensors, op=resolve_op(op, average), axis=axis,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor)
    return [synchronize(h) for h in grouped_allreduce_async(
        tensors, average, name, op, prescale_factor, postscale_factor)]


def allgather(tensor, name=None, axis=None):
    """Every rank's ``tensor`` concatenated along dim 0 in rank order; the
    first dims may differ."""
    if axis is not None:
        return collectives.allgather(tensor, axis=axis)
    return synchronize(allgather_async(tensor, name))


def broadcast(tensor, root_rank, name=None, axis=None):
    """``root_rank``'s ``tensor`` on every rank."""
    if axis is not None:
        return collectives.broadcast(tensor, root_rank, axis=axis)
    return synchronize(broadcast_async(tensor, root_rank, name))


def alltoall(tensor, splits=None, name=None, axis=None):
    """Row slices of ``tensor`` sent to each rank (``splits[i]`` rows to
    rank i; even slices without), the rows received concatenated in rank
    order."""
    if axis is not None:
        if splits is not None:
            raise ValueError(
                "ragged alltoall (splits=...) is eager-only; the in-step "
                "collective takes the even split form")
        return collectives.alltoall(tensor, axis=axis)
    return synchronize(alltoall_async(tensor, splits, name))
