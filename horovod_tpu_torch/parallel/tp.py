"""Tensor parallelism: Megatron-style column/row-parallel linear algebra
over the ``model`` mesh axis.

Counterpart of ``horovod_tpu/parallel/tp.py``:

- **column-parallel** ``y = x @ W``: W is split on its *output* dim, each
  rank computes its slice of y, no communication.
- **row-parallel** ``y = x @ W``: W is split on its *input* dim and x
  arrives already split (the column output); partial products are summed
  over the ``model`` axis.

One sum per column→row pair. Weights are this rank's shards, ``[d, h/n]``
and ``[h/n, d]`` in the reference's ``[in, out]`` layout; the caller
slices them as the reference's ``PartitionSpec``s do. The nonlinearity
defaults to GELU's tanh approximation, as ``jax.nn.gelu`` does
(``F.gelu``'s default is the exact erf).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from horovod_tpu_torch.parallel import collectives

gelu_tanh = functools.partial(F.gelu, approximate="tanh")


def _psum(x: torch.Tensor, axis) -> torch.Tensor:
    return collectives.allreduce(x, op=collectives.Sum, axis=axis)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.axis), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's ``f`` operator: identity forward, sum backward — wraps a
    replicated activation entering a column-parallel layer so that its
    gradient sums every rank's contribution. (An allreduce whose backward
    is again an allreduce would count the replicated cotangent once per
    rank.)"""
    return _CopyToTP.apply(x, axis)


def reduce_from_tp(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's ``g`` operator: sum forward, identity backward — the
    row-parallel output reduction whose cotangent is already replicated."""
    return _ReduceFromTP.apply(x, axis)


def column_parallel(x: torch.Tensor, w_shard: torch.Tensor,
                    b_shard: Optional[torch.Tensor] = None,
                    axis="model") -> torch.Tensor:
    """``x @ W`` with W column-sharded: returns this rank's output slice
    ``[..., h/n]``. No forward communication (the input gradient sums)."""
    y = copy_to_tp(x, axis) @ w_shard
    if b_shard is not None:
        y = y + b_shard
    return y


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor,
                 b: Optional[torch.Tensor] = None,
                 axis="model") -> torch.Tensor:
    """``x @ W`` with W row-sharded and x already split on its last dim:
    partial products summed over ``axis``. ``b`` is the full (replicated)
    bias, added once after the reduction."""
    y = reduce_from_tp(x_shard @ w_shard, axis)
    if b is not None:
        y = y + b
    return y


def tp_mlp(x: torch.Tensor, w_in_shard: torch.Tensor,
           w_out_shard: torch.Tensor, activation: Callable = gelu_tanh,
           axis="model") -> torch.Tensor:
    """The Megatron two-layer MLP: column-parallel up-projection, nonlinear
    elementwise on the shard, row-parallel down-projection — exactly one
    sum for the whole block."""
    h = activation(column_parallel(x, w_in_shard, axis=axis))
    return row_parallel(h, w_out_shard, axis=axis)


# ---------------------------------------------------------------------------
# Inference path: forward-only TP whose reduction may ride the int8 wire
# (reference tp.py:86-100, EQuARX applied to activations).


def row_parallel_inference(x_shard: torch.Tensor, w_shard: torch.Tensor,
                           b: Optional[torch.Tensor] = None,
                           axis="model", compression=None) -> torch.Tensor:
    """Forward-only :func:`row_parallel` whose reduction can ride the int8
    quantized wire: a ``compression`` with ``quantized = True`` (the
    port's ``Compression.int8``) routes the partial-product sum through
    ``quantized_allreduce`` (block ``block_size``, default 256); anything
    else is a plain sum. Bias is replicated, added after the reduction.
    ``axis=None`` is the whole layer on this device, a world of one with
    no group: no sum, and the int8 wire's two codec round trips."""
    y = x_shard @ w_shard
    if compression is not None and getattr(compression, "quantized", False):
        y = collectives.quantized_allreduce(
            y, op=collectives.Sum, axis=axis,
            block_size=getattr(compression, "block_size", 256))
    elif axis is not None:
        y = _psum(y, axis)
    if b is not None:
        y = y + b
    return y


def tp_mlp_inference(x: torch.Tensor, w_in_shard: torch.Tensor,
                     w_out_shard: torch.Tensor,
                     activation: Callable = gelu_tanh, axis="model",
                     compression=None) -> torch.Tensor:
    """Forward-only :func:`tp_mlp` with a selectable activation wire format
    for its single reduction (the serving executor's building block)."""
    h = activation(x @ w_in_shard)
    return row_parallel_inference(h, w_out_shard, axis=axis,
                                  compression=compression)


def tp_activation_wire_bytes(n_elements: int, world: int,
                             compression=None,
                             wire_bytes_per_elem: float = 4.0) -> int:
    """Ring-allreduce wire bytes per rank for one activation reduction of
    ``n_elements``. fp32 moves ``2*(world-1)/world * 4`` bytes/element
    (reduce-scatter + all-gather phases); the quantized path moves int8
    payloads plus one fp32 scale per block on each phase."""
    if world <= 1:
        return 0
    phase = 2.0 * (world - 1) / world
    if compression is not None and getattr(compression, "quantized", False):
        block = getattr(compression, "block_size", 256)
        per_elem = 1.0 + 4.0 / block
    else:
        per_elem = wire_bytes_per_elem
    return int(phase * per_elem * n_elements)
