"""Map a flax GPT parameter tree onto the port's modules.

``from_flax_params(tree)`` takes the ``params`` tree of the reference's
``GptDecoder`` (``horovod_tpu/models/gpt.py``) as nested dicts of numpy
arrays and returns a ``state_dict`` for :class:`GptDecoder` here. Every key
of the tree must be consumed and every expected key present; anything else
raises ``KeyError``. The same mapping serves any tree shaped like the params
(optimizer moments, gradients).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_BLOCK = re.compile(r"EncoderBlock_(\d+)$")
# flax names the attention module by which path built it
_ATTN = ("FlashSelfAttention_0", "MultiHeadDotProductAttention_0")


class _Tree:
    """Read-once view of a nested dict: ``take`` pops a leaf, ``leftover``
    lists what was never taken."""

    def __init__(self, tree):
        self._tree = {k: (_Tree(v) if isinstance(v, dict) else v)
                      for k, v in tree.items()}

    def take(self, *path: str):
        node = self
        for i, key in enumerate(path):
            if key not in node._tree:
                raise KeyError(f"flax tree is missing {'/'.join(path[:i + 1])}")
            node = node._tree[key] if i < len(path) - 1 else \
                node._tree.pop(key)
        return np.asarray(node)

    def leftover(self, prefix: str = ""):
        out = []
        for k, v in self._tree.items():
            if isinstance(v, _Tree):
                out += v.leftover(f"{prefix}{k}/")
            else:
                out.append(prefix + k)
        return out


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def from_flax_params(tree) -> Dict[str, torch.Tensor]:
    """flax GptDecoder params -> the port's GptDecoder ``state_dict``."""
    src = _Tree(tree)
    blocks = sorted(int(m.group(1)) for k in tree
                    if (m := _BLOCK.match(k)))
    if blocks != list(range(len(blocks))):
        raise KeyError(f"EncoderBlock indices are not 0..n-1: {blocks}")
    sd = {"embed": _t(src.take("Embed_0", "embedding")),
          "pos_embed": _t(src.take("Embed_1", "embedding"))}
    for i in blocks:
        blk, out = f"EncoderBlock_{i}", f"blocks.{i}"
        for ln_src, ln_dst in (("LayerNorm_0", "ln0"), ("LayerNorm_1", "ln1")):
            sd[f"{out}.{ln_dst}.weight"] = _t(src.take(blk, ln_src, "scale"))
            sd[f"{out}.{ln_dst}.bias"] = _t(src.take(blk, ln_src, "bias"))
        attn = next((a for a in _ATTN if a in tree[blk]), _ATTN[0])
        for name in ("query", "key", "value"):
            kernel = src.take(blk, attn, name, "kernel")  # [d, h, hd]
            d = kernel.shape[0]
            sd[f"{out}.attn.{name}.weight"] = _t(kernel.reshape(d, -1).T)
            sd[f"{out}.attn.{name}.bias"] = _t(
                src.take(blk, attn, name, "bias").reshape(-1))
        kernel = src.take(blk, attn, "out", "kernel")  # [h, hd, d]
        sd[f"{out}.attn.out.weight"] = _t(
            kernel.reshape(-1, kernel.shape[-1]).T)
        sd[f"{out}.attn.out.bias"] = _t(src.take(blk, attn, "out", "bias"))
        for dense_src, dense_dst in (("Dense_0", "mlp0"), ("Dense_1", "mlp1")):
            sd[f"{out}.{dense_dst}.weight"] = _t(
                src.take(blk, dense_src, "kernel").T)
            sd[f"{out}.{dense_dst}.bias"] = _t(
                src.take(blk, dense_src, "bias"))
    sd["ln_f.weight"] = _t(src.take("LayerNorm_0", "scale"))
    sd["ln_f.bias"] = _t(src.take("LayerNorm_0", "bias"))
    left = src.leftover()
    if left:
        raise KeyError(f"flax tree keys not mapped: {left}")
    return sd
