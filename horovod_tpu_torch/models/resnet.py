"""ResNet family (v1.5), the benchmark flagship.

Counterpart of ``horovod_tpu/models/resnet.py`` (``ResNet``,
``BottleneckBlock``, ``ResNetBlock``, ``ResNet18`` ... ``ResNet152``,
``pad_channels_to_multiple``) with the same mixed-precision policy:

- ``dtype`` is the compute dtype of the convolutions and of the BatchNorm
  outputs; ``param_dtype`` (fp32) holds the weights, the BatchNorm scale and
  bias and the running statistics.
- The input is NHWC, as in the reference (``input_layout="NCHW"`` transposes
  once at entry). ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is
  already ``channels_last`` in memory, so cuDNN gets NHWC with no copy. The
  convolutions and the head stay ``F.conv2d``/``F.linear`` (cuDNN and
  cuBLAS), as the reference leaves them to XLA: no Pallas kernel exists for
  them.
- flax's ``padding="SAME"`` is computed as ``lax.padtype_to_pads`` does:
  a 3x3 stride-2 convolution of an even size pads (0, 1), not (1, 1).
- :class:`BatchNorm` has flax's semantics, not ``nn.BatchNorm2d``'s:
  statistics reduced in fp32, a biased variance E[x^2] - mean^2 clamped at 0
  (the running var stores that biased value), running statistics
  ``ra = 0.9 ra + 0.1 batch``, output ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias`` in fp32 cast to ``dtype``; eval mode uses the running
  statistics. The last BatchNorm of every block starts with scale zero.
- The head averages the activations over space in fp32, rounds to
  ``dtype``, and applies an fp32 Dense: fp32 logits.

Random weights come from :meth:`ResNet.reset_parameters`; until it (or
``load_state_dict``) runs the convolution and Dense weights are
uninitialized.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.convert import resnet_entries, tag_leaves
from horovod_tpu_torch.models.transformer import Dense, lecun_normal_


def pad_channels_to_multiple(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad the trailing (channel) dim up to a multiple. Exact for convs:
    zero channels contribute nothing to any output element."""
    if multiple <= 1:
        return x
    pad = (-x.shape[-1]) % multiple
    return F.pad(x, (0, pad)) if pad else x


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """(before, after) padding of flax's ``padding="SAME"`` along one
    spatial dim (``lax.padtype_to_pads``): the output has ceil(size /
    stride) positions and an odd total puts the extra one after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)`` on an NCHW-indexed tensor: weight
    ``[out, in, k, k]`` in the parameter dtype, product in ``dtype``.
    ``padding`` is ``"SAME"`` or an explicit (before, after) per spatial
    dim."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding="SAME", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        if self.padding == "SAME":
            (hl, hh), (wl, wh) = (same_pads(n, k, self.stride)
                                  for n in x.shape[2:])
        else:
            (hl, hh), (wl, wh) = self.padding
        w = self.weight.to(self.dtype)
        if hl == hh and wl == wh:
            return F.conv2d(x, w, None, self.stride, (hl, wl))
        x = F.pad(x, (wl, wh, hl, hh))
        return F.conv2d(x.contiguous(memory_format=torch.channels_last), w,
                        None, self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over dim 1 of an
    NCHW-indexed tensor (see the module docstring). Parameters ``scale``,
    ``bias``; buffers ``mean``, ``var``."""

    momentum = 0.9
    epsilon = 1e-5

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 zero_scale: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.full((features,),
                                             0.0 if zero_scale else 1.0))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.dtype, self.zero_scale = dtype, zero_scale

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            dims = (0, *range(2, x.dim()))
            mean = xf.mean(dims)
            var = (xf.square().mean(dims) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with projection shortcut (v1.5: stride
    on the 3x3)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cout = filters * 4
        self.conv0 = Conv(cin, filters, 1, dtype=dtype)
        self.bn0 = BatchNorm(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, stride, dtype=dtype)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = Conv(filters, cout, 1, dtype=dtype)
        self.bn2 = BatchNorm(cout, dtype, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if cin != cout or stride != 1:
            self.conv_proj = Conv(cin, cout, 1, stride, dtype=dtype)
            self.norm_proj = BatchNorm(cout, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x), train))
        y = F.relu(self.bn1(self.conv1(y), train))
        y = self.bn2(self.conv2(y), train)
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x), train)
        return F.relu(x + y)


class ResNetBlock(nn.Module):
    """Two 3x3 convs (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = Conv(cin, filters, 3, stride, dtype=dtype)
        self.bn0 = BatchNorm(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, dtype=dtype)
        self.bn1 = BatchNorm(filters, dtype, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if cin != filters or stride != 1:
            self.conv_proj = Conv(cin, filters, 1, stride, dtype=dtype)
            self.norm_proj = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x), train))
        y = self.bn1(self.conv1(y), train)
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x), train)
        return F.relu(x + y)


class ResNet(nn.Module):
    """Stem (7x7/2 conv, BatchNorm, ReLU, 3x3/2 max pool), stages of
    blocks (stride 2 at the first block of every stage but the first), a
    spatial mean and a Dense head. ``forward(x, train=False)`` takes NHWC
    images (NCHW with ``input_layout="NCHW"``) and returns fp32 logits; in
    train mode BatchNorm uses batch statistics and updates its running
    ones."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 input_layout: str = "NHWC", pad_stem_to: int = 0):
        super().__init__()
        if input_layout not in ("NHWC", "NCHW"):
            raise ValueError(f"input_layout must be NHWC or NCHW, got "
                             f"{input_layout!r}")
        self.dtype, self.input_layout = dtype, input_layout
        self.pad_stem_to = pad_stem_to
        stem_in = 3  # RGB
        if pad_stem_to > 1:
            stem_in += (-stem_in) % pad_stem_to
        self.conv_init = Conv(stem_in, num_filters, 7, 2,
                              padding=((3, 3), (3, 3)), dtype=dtype)
        self.bn_init = BatchNorm(num_filters, dtype)
        blocks: List[nn.Module] = []
        cin = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                blocks.append(block_cls(cin, filters, stride, dtype))
                cin = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(cin, num_classes, torch.float32)
        tag_leaves(self, resnet_entries(
            [(type(b).__name__, b.conv_proj is not None)
             for b in self.blocks])[0])
        # flax keeps the running statistics fp32 whatever param_dtype is
        for p in self.parameters():
            p.data = p.data.to(param_dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers from ``generator``: lecun-normal
        (truncated) conv and Dense kernels, fan_in ``kh * kw * cin`` and
        ``in``, zero Dense bias, BatchNorm scale one (zero for the last of
        each block), bias zero, running mean zero and var one."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (Conv, Dense)):
                    lecun_normal_(mod.weight, mod.weight[0].numel(),
                                  generator)
                    if isinstance(mod, Dense):
                        mod.bias.zero_()
                elif isinstance(mod, BatchNorm):
                    mod.scale.fill_(0.0 if mod.zero_scale else 1.0)
                    mod.bias.zero_()
                    mod.mean.zero_()
                    mod.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(f"expected a rank-4 image batch, got "
                             f"{tuple(x.shape)}")
        if self.input_layout == "NCHW":
            x = x.permute(0, 2, 3, 1)
        x = pad_channels_to_multiple(x.to(self.dtype), self.pad_stem_to)
        x = x.permute(0, 3, 1, 2)  # NCHW indexing, channels_last memory
        x = F.relu(self.bn_init(self.conv_init(x), train))
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x, train)
        x = x.float().mean((2, 3)).to(self.dtype)
        return self.head(x).float()


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckBlock)
