"""Collectives over the job's process group.

Counterpart of ``horovod_tpu/parallel/collectives.py``. The reference
expresses collectives inside a compiled program over named mesh axes; the
port issues ``torch.distributed`` collectives (NCCL on the card, gloo on the
CPU) over the one ``data`` axis, i.e. the whole process group. The functions
are functional, as in the reference: the input tensor is left unchanged and
the result is a new tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.reduce_ops import (  # noqa: F401 (re-exported)
    Adasum, Average, Max, Min, Op, Product, Sum,
)

DEFAULT_AXIS = "data"

_HALF = (torch.float16, torch.bfloat16)


def _check_axis(axis) -> None:
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    if any(a != DEFAULT_AXIS for a in axes):
        raise NotImplementedError(
            f"axis {axis!r}: only the 'data' axis is supported so far; see "
            "ROADMAP.md queue A, 'Remaining parallelism'")


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
    _check_axis(axis)
    return basics.size()


def axis_rank(axis=DEFAULT_AXIS) -> int:
    """This replica's index on ``axis``."""
    _check_axis(axis)
    return basics.rank()


def allreduce(x: torch.Tensor,
              op: Op = Average,
              axis=DEFAULT_AXIS,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0,
              accumulate_in_fp32: bool = True) -> torch.Tensor:
    """Reduce ``x`` across the replicas. Average is a SUM divided by the
    world size, as in the reference (collectives.py:108-111).
    ``accumulate_in_fp32=False`` keeps fp16/bf16 inputs in their dtype on the
    wire, which is the point of 16-bit compression."""
    _check_axis(axis)
    n = basics.size()
    x = _scale(x, prescale_factor)
    if op in (Average, Sum):
        orig_dtype = x.dtype
        if accumulate_in_fp32 and orig_dtype in _HALF:
            out = x.float()
        else:
            out = x.clone()
        dist.all_reduce(out, dist.ReduceOp.SUM)
        if op is Average:
            out = out / n
        out = out.to(orig_dtype)
    elif op in (Min, Max):
        out = x.clone()
        dist.all_reduce(out, dist.ReduceOp.MIN if op is Min
                        else dist.ReduceOp.MAX)
    elif op in (Product, Adasum):
        raise NotImplementedError(
            f"allreduce op {op.name} is not ported yet; see ROADMAP.md "
            "queue A, 'Collectives, the rest' (Product) and 'Remaining "
            "parallelism' (Adasum)")
    else:
        raise ValueError(f"unknown op {op}")
    return _scale(out, postscale_factor)


def broadcast(x: torch.Tensor, root_rank: int = 0,
              axis=DEFAULT_AXIS) -> torch.Tensor:
    """``x`` as held by ``root_rank``, on every replica."""
    _check_axis(axis)
    out = x.detach().clone()
    dist.broadcast(out, src=root_rank)
    return out
