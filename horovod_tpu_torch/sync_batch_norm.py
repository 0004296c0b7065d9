"""Cross-replica synchronized batch normalization.

Counterpart of ``horovod_tpu/jax/sync_batch_norm.py`` (``SyncBatchNorm``):
per-replica sum, sum of squares and count packed into one fp32 Sum allreduce
over the replica axes, then normalization with the global statistics. The
features are the last dim, as in flax. ``dist.all_reduce`` is not
differentiable, so the allreduce is an autograd function whose backward is
again a Sum allreduce of the cotangent: the transpose ``lax.psum`` has under
the reference's ``shard_map(check_vma=False)``, which makes each replica's
input gradient that of the sum of every replica's loss.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.parallel.collectives import Sum


class _AllreduceSum(torch.autograd.Function):
    """Sum over the replicas of ``axes``; the backward sums the cotangents
    the same way."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return collectives.allreduce(x, op=Sum, axis=axes)

    @staticmethod
    def backward(ctx, grad):
        return collectives.allreduce(grad.contiguous(), op=Sum,
                                     axis=ctx.axes), None


class SyncBatchNorm(nn.Module):
    """Drop-in BatchNorm that reduces statistics across replicas.

    Statistics are reduced in fp32 over every dim but the last; the
    variance is E[x^2] - mean^2 (biased); the running statistics follow
    flax, ``ra = momentum * ra + (1 - momentum) * batch``; the output is
    normalized in fp32 and returned in ``dtype`` (default: the input's).
    Outside an initialized job it is a plain BatchNorm over the local
    batch, as the reference is outside a mesh. Parameters ``scale``,
    ``bias``; buffers ``mean``, ``var``.
    """

    def __init__(self, num_features: int,
                 axes: Tuple[str, ...] = ("data", "fsdp"),
                 momentum: float = 0.9, epsilon: float = 1e-5,
                 dtype: Optional[torch.dtype] = None,
                 use_running_average: bool = False):
        super().__init__()
        self.axes, self.momentum, self.epsilon = tuple(axes), momentum, epsilon
        self.dtype, self.use_running_average = dtype, use_running_average
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        use_ra = (self.use_running_average if use_running_average is None
                  else use_running_average)
        xf = x.float()
        if use_ra:
            mean, var = self.mean, self.var
        else:
            features = x.shape[-1]
            dims = tuple(range(x.dim() - 1))
            count = float(math.prod(x.shape[:-1]))
            local_sum = xf.sum(dims)
            local_sqsum = (xf * xf).sum(dims)
            if basics.is_initialized():
                packed = torch.cat([local_sum, local_sqsum,
                                    local_sum.new_full((1,), count)])
                packed = _AllreduceSum.apply(packed, self.axes)
                total_sum = packed[:features]
                total_sqsum = packed[features:2 * features]
                count = packed[-1]
            else:
                total_sum, total_sqsum = local_sum, local_sqsum
            mean = total_sum / count
            var = total_sqsum / count - mean * mean
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.scale + self.bias
        return y.to(self.dtype or x.dtype)
