"""Pre-LN transformer blocks with length-routed flash attention.

Counterpart of ``horovod_tpu/models/transformer.py`` (``FlashSelfAttention``,
``EncoderBlock``). Same precision policy as the reference's flax modules:
parameters are fp32, computation runs in ``dtype``. The flax defaults are
kept where they differ from PyTorch's: LayerNorm eps 1e-6 with statistics in
fp32, tanh-approximated GELU, and Dense layers that cast input, kernel and
bias to ``dtype``. Weights are stored in PyTorch's ``Linear`` layout
(``[out, in]``); ``models/convert.py`` maps a flax tree onto them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.ops.flash_attention import attention, masked_attention


class Dense(nn.Module):
    """``nn.Dense`` with ``dtype``: fp32 parameters, product in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: eps 1e-6, statistics and affine in
    fp32, result in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         eps=1e-6)
        return y.to(self.dtype)


class FlashSelfAttention(nn.Module):
    """Self-attention whose core is the length-routed attention op: q/k/v/out
    projections as in ``nn.MultiHeadDotProductAttention``. From the crossover
    (``HOROVOD_FLASH_MIN_SEQ``) up the flash kernels run; below it the dense
    path does. ``mask`` (boolean, broadcastable to [B, H, Tq, Tk]) is only
    taken by the dense path, which the caller then forces with
    ``use_flash=False``."""

    def __init__(self, hidden: int, heads: int,
                 dtype: torch.dtype = torch.bfloat16, causal: bool = False):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden dim {hidden} must be divisible by "
                             f"heads ({heads})")
        self.heads, self.head_dim = heads, hidden // heads
        self.causal = causal
        self.query = Dense(hidden, hidden, dtype)
        self.key = Dense(hidden, hidden, dtype)
        self.value = Dense(hidden, hidden, dtype)
        self.out = Dense(hidden, hidden, dtype)

    def forward(self, x: torch.Tensor, use_flash: bool = True,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        shape = (b, t, self.heads, self.head_dim)
        q = self.query(x).view(shape)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        if use_flash:
            o = attention(q, k, v, causal=self.causal)
        else:
            o = masked_attention(q, k, v, mask)
        return self.out(o.reshape(b, t, d))


class EncoderBlock(nn.Module):
    """Pre-LN transformer block; ``causal=True`` makes it a decoder block
    (the GPT family uses it so)."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = False,
                 causal: bool = False):
        super().__init__()
        self.use_flash, self.causal = use_flash, causal
        self.ln0 = LayerNorm(hidden, dtype)
        self.attn = FlashSelfAttention(hidden, heads, dtype, causal)
        self.ln1 = LayerNorm(hidden, dtype)
        self.mlp0 = Dense(hidden, mlp_dim, dtype)
        self.mlp1 = Dense(mlp_dim, hidden, dtype)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.ln0(x)
        if self.use_flash:
            if mask is not None:
                raise ValueError("use_flash supports mask=None (full "
                                 "bidirectional) or causal only")
            h = self.attn(h)
        else:
            if self.causal:
                if mask is not None:
                    raise ValueError("causal=True builds its own mask")
                t = x.shape[1]
                mask = torch.ones((t, t), dtype=torch.bool,
                                  device=x.device).tril()
            h = self.attn(h, use_flash=False, mask=mask)
        x = x + h
        h = self.ln1(x)
        h = F.gelu(self.mlp0(h), approximate="tanh")
        return x + self.mlp1(h)
