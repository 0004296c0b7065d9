"""Pre-LN transformer blocks with length-routed flash attention, and the
BERT encoder built from them.

Counterpart of ``horovod_tpu/models/transformer.py`` (``FlashSelfAttention``,
``EncoderBlock``, ``BertEncoder``, ``BertBase``, ``BertLarge``). Same
precision policy as the reference's flax modules: parameters are fp32,
computation runs in ``dtype``. The flax defaults are kept where they differ
from PyTorch's: LayerNorm eps 1e-6 with statistics in fp32,
tanh-approximated GELU, Dense layers that cast input, kernel and bias to
``dtype``, and flax's initializers (:func:`lecun_normal_`,
:func:`embed_normal_`). Weights are stored in PyTorch's ``Linear`` layout
(``[out, in]``); ``models/convert.py`` maps a flax tree onto them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.convert import bert_entries, tag_leaves
from horovod_tpu_torch.ops.flash_attention import attention, masked_attention

# std of a unit normal truncated at +-2: flax's variance_scaling divides by
# it so that the truncated draw keeps the variance asked for
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel initializer (``lecun_normal``): a normal of
    variance ``1 / fan_in`` truncated at two of its standard deviations,
    std ``fan_in^-1/2 / 0.8796``. ``fan_in`` is the input width of a Dense,
    ``kh * kw * cin`` of a convolution."""
    std = fan_in ** -0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def embed_normal_(weight: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Embed``'s default initializer for a ``[rows, features]``
    table: a plain (untruncated) normal of variance ``1 / features``."""
    with torch.no_grad():
        return weight.normal_(0.0, weight.shape[1] ** -0.5,
                              generator=generator)


def reset_blocks_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's initializers on every ``Dense`` and ``LayerNorm`` under
    ``module``: lecun-normal kernels, zero biases, unit scales."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, Dense):
                lecun_normal_(mod.weight, mod.weight.shape[1], generator)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


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


def attention_names(blocks) -> list:
    """The name flax gives each block's attention module: the reference
    builds ``FlashSelfAttention`` with ``use_flash`` and
    ``nn.MultiHeadDotProductAttention`` without."""
    return ["FlashSelfAttention_0" if b.use_flash
            else "MultiHeadDotProductAttention_0" for b in blocks]


class BertEncoder(nn.Module):
    """Masked-LM encoder (reference transformer.py:87-116): token and
    position embeddings, an embedding LayerNorm, N bidirectional pre-LN
    blocks, a final LayerNorm, an LM head tied to the token embedding and
    an fp32 ``lm_bias``; fp32 logits. ``use_flash`` (default False, as in
    the reference) routes attention by length: from
    ``HOROVOD_FLASH_MIN_SEQ`` up through the flash kernels, non-causal."""

    def __init__(self, vocab: int = 30522, layers: int = 12,
                 hidden: int = 768, heads: int = 12, mlp_dim: int = 3072,
                 max_len: int = 512, dtype: torch.dtype = torch.bfloat16,
                 use_flash: bool = False):
        super().__init__()
        self.dtype = dtype
        self.embed = nn.Parameter(torch.empty(vocab, hidden))
        self.pos_embed = nn.Parameter(torch.empty(max_len, hidden))
        self.ln_embed = LayerNorm(hidden, dtype)
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden, heads, mlp_dim, dtype, use_flash=use_flash)
            for _ in range(layers))
        self.ln_f = LayerNorm(hidden, dtype)
        self.lm_bias = nn.Parameter(torch.zeros(vocab))
        tag_leaves(self, bert_entries(attention_names(self.blocks)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers from ``generator``: embeddings N(0,
        1/hidden), lecun-normal Dense kernels, zero biases and
        ``lm_bias``, unit LayerNorm scales."""
        embed_normal_(self.embed, generator)
        embed_normal_(self.pos_embed, generator)
        reset_blocks_(self, generator)
        with torch.no_grad():
            self.lm_bias.zero_()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        t = tokens.shape[1]
        x = F.embedding(tokens, self.embed).to(self.dtype)
        x = self.ln_embed(x + self.pos_embed[:t].to(self.dtype)[None])
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x)
        logits = x @ self.embed.to(self.dtype).t()  # tied LM head
        return logits.float() + self.lm_bias


def BertBase(**kw) -> BertEncoder:
    """BERT-Base geometry (12 layers, hidden 768, 12 heads)."""
    return BertEncoder(layers=12, hidden=768, heads=12, mlp_dim=3072, **kw)


def BertLarge(**kw) -> BertEncoder:
    """BERT-Large geometry (24 layers, hidden 1024, 16 heads)."""
    return BertEncoder(layers=24, hidden=1024, heads=16, mlp_dim=4096, **kw)


def mlm_loss(model: BertEncoder, batch: dict):
    """Cross entropy in fp32 of the logits of ``batch["tokens"]`` against
    ``batch["labels"]`` over every position (the loss of the reference's
    BERT benchmark, bench.py:228-232). Returns ``(loss, {})``."""
    logits = model(batch["tokens"])
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["labels"].reshape(-1))
    return loss, {}
