"""Decoder-only transformer LM (GPT family).

Counterpart of ``horovod_tpu/models/gpt.py`` (``GptDecoder``, ``GptSmall``,
``GptMedium``): token and position embeddings, N causal pre-LN blocks, a
final LayerNorm and an LM head tied to the token embedding, with fp32
logits. With ``use_flash=True`` (the default) every block's attention takes
the flash kernels from ``HOROVOD_FLASH_MIN_SEQ`` tokens up.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.convert import gpt_entries, tag_leaves
from horovod_tpu_torch.models.transformer import (EncoderBlock, LayerNorm,
                                                  attention_names,
                                                  embed_normal_,
                                                  reset_blocks_)


class GptDecoder(nn.Module):
    """Causal LM: embeddings -> N decoder blocks -> tied LM head."""

    def __init__(self, vocab: int = 50257, layers: int = 12,
                 hidden: int = 768, heads: int = 12, mlp_dim: int = 3072,
                 max_len: int = 1024, dtype: torch.dtype = torch.bfloat16,
                 use_flash: bool = True):
        super().__init__()
        self.dtype = dtype
        self.embed = nn.Parameter(torch.empty(vocab, hidden))
        self.pos_embed = nn.Parameter(torch.empty(max_len, hidden))
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden, heads, mlp_dim, dtype, use_flash=use_flash,
                         causal=True) for _ in range(layers))
        self.ln_f = LayerNorm(hidden, dtype)
        tag_leaves(self, gpt_entries(attention_names(self.blocks)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers from ``generator``: embeddings N(0,
        1/hidden), lecun-normal (truncated) Dense kernels, zero biases,
        unit LayerNorm scales."""
        embed_normal_(self.embed, generator)
        embed_normal_(self.pos_embed, generator)
        reset_blocks_(self, generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        t = tokens.shape[1]
        x = F.embedding(tokens, self.embed).to(self.dtype)
        x = x + self.pos_embed[:t].to(self.dtype)[None]
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x)
        logits = x @ self.embed.to(self.dtype).t()  # tied LM head
        return logits.float()


def GptSmall(**kw) -> GptDecoder:
    """GPT-2 small geometry (124M params)."""
    return GptDecoder(layers=12, hidden=768, heads=12, mlp_dim=3072, **kw)


def GptMedium(**kw) -> GptDecoder:
    """GPT-2 medium geometry (350M params)."""
    return GptDecoder(layers=24, hidden=1024, heads=16, mlp_dim=4096, **kw)


def lm_loss(model: GptDecoder, tokens: torch.Tensor):
    """Next-token cross entropy in fp32, averaged over positions; the loss of
    the reference's GPT example. Returns ``(loss, {})``."""
    logits = model(tokens)
    loss = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))
    return loss, {}
