"""MNIST ConvNet, the smallest end-to-end training model.

Counterpart of ``horovod_tpu/models/mnist.py`` (``MnistConvNet``): two
VALID 5x5 convolutions with 2x2 max pools and ReLU, a Dense of 50, dropout
0.5 and a Dense head, fp32 logits. The input is NHWC ``[B, 28, 28, 1]`` and
the flatten before the first Dense is in NHWC order (H, W, C), as in the
reference, so flax's ``Dense_0`` kernel maps row for row. Dropout draws from
the generator the caller passes, which the train step seeds per replica.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.convert import mnist_entries, tag_leaves
from horovod_tpu_torch.models.transformer import Dense, lecun_normal_


class MnistConvNet(nn.Module):
    """conv(10) -> pool -> relu -> conv(20) -> pool -> relu -> Dense(50) ->
    relu -> dropout -> Dense(num_classes), fp32 parameters, compute in
    ``dtype``, fp32 logits."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Conv2d(1, 10, 5)
        self.conv1 = nn.Conv2d(10, 20, 5)
        self.dense0 = Dense(320, 50, dtype)
        self.dense1 = Dense(50, num_classes, dtype)
        tag_leaves(self, mnist_entries())

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers from ``generator``: lecun-normal (truncated)
        kernels, fan_in ``kh * kw * cin`` for the convolutions, and zero
        biases."""
        with torch.no_grad():
            for mod in (self.conv0, self.conv1, self.dense0, self.dense1):
                lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
                mod.bias.zero_()

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, conv.weight.to(self.dtype),
                        conv.bias.to(self.dtype))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x``: ``[B, 28, 28, 1]``. In train mode dropout needs
        ``generator`` (flax likewise needs a dropout rng)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(F.max_pool2d(self._conv(self.conv0, x), 2, 2))
        x = F.relu(F.max_pool2d(self._conv(self.conv1, x), 2, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = F.relu(self.dense0(x))
        if train:
            x = dropout(x, 0.5, generator)
        return self.dense1(x).float()


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate); the mask is drawn from
    ``generator``, which must live on ``x``'s device."""
    if generator is None:
        raise ValueError("dropout in train mode needs a generator; the "
                         "train step passes one when it is given a seed")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
