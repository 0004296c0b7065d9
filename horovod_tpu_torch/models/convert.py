"""Map flax parameter trees onto the port's modules.

``from_flax_params(tree)`` takes the ``params`` tree of the reference's
``GptDecoder`` (``horovod_tpu/models/gpt.py``), ``from_flax_bert(tree)``
that of its ``BertEncoder`` (``models/transformer.py``),
``from_flax_resnet(params,
batch_stats)`` those of its ``ResNet`` family (``models/resnet.py``, running
statistics included) and ``from_flax_mnist(params)`` those of its
``MnistConvNet``, as nested dicts of numpy arrays, and return a
``state_dict`` for the port's module. Every key of the trees must be
consumed and every expected key present; anything else raises ``KeyError``.
The same mapping serves any tree shaped like the params (optimizer moments,
gradients). Layouts: conv kernels ``[kh, kw, in, out]`` become ``[out, in,
kh, kw]``, Dense kernels ``[in, out]`` become ``[out, in]``.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_BLOCK = re.compile(r"EncoderBlock_(\d+)$")
_RESNET_BLOCK = re.compile(r"(BottleneckBlock|ResNetBlock)_(\d+)$")
# convs (and their BatchNorms) of each ResNet block kind
_RESNET_CONVS = {"BottleneckBlock": 3, "ResNetBlock": 2}
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


def _conv(kernel: np.ndarray) -> torch.Tensor:
    """flax conv kernel [kh, kw, in, out] -> torch [out, in, kh, kw]."""
    return _t(np.transpose(kernel, (3, 2, 0, 1)))


def _check_consumed(*trees: _Tree) -> None:
    left = [k for t in trees for k in t.leftover()]
    if left:
        raise KeyError(f"flax tree keys not mapped: {left}")


def _indices(tree, pattern) -> list:
    """Sorted (kind, index) of the keys of ``tree`` matching ``pattern``;
    the indices must be 0..n-1."""
    found = sorted(((m.group(1), int(m.group(2))) for k in tree
                    if (m := pattern.match(k))), key=lambda t: t[1])
    if [i for _, i in found] != list(range(len(found))):
        raise KeyError(f"block indices are not 0..n-1: {found}")
    return found


def from_flax_resnet(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """flax ResNet ``params`` (and ``batch_stats``: the running ``mean`` and
    ``var`` buffers) -> the port's ResNet ``state_dict``. Without
    ``batch_stats`` only the parameters are mapped (a gradient tree)."""
    src = _Tree(params)
    stats = _Tree(batch_stats) if batch_stats is not None else None
    sd: Dict[str, torch.Tensor] = {}

    def norm(path, out):
        sd[f"{out}.scale"] = _t(src.take(*path, "scale"))
        sd[f"{out}.bias"] = _t(src.take(*path, "bias"))
        if stats is not None:
            sd[f"{out}.mean"] = _t(stats.take(*path, "mean"))
            sd[f"{out}.var"] = _t(stats.take(*path, "var"))

    sd["conv_init.weight"] = _conv(src.take("conv_init", "kernel"))
    norm(("bn_init",), "bn_init")
    for kind, i in _indices(params, _RESNET_BLOCK):
        blk, out = f"{kind}_{i}", f"blocks.{i}"
        for j in range(_RESNET_CONVS[kind]):
            sd[f"{out}.conv{j}.weight"] = _conv(
                src.take(blk, f"Conv_{j}", "kernel"))
            norm((blk, f"BatchNorm_{j}"), f"{out}.bn{j}")
        if "conv_proj" in params[blk]:
            sd[f"{out}.conv_proj.weight"] = _conv(
                src.take(blk, "conv_proj", "kernel"))
            norm((blk, "norm_proj"), f"{out}.norm_proj")
    sd["head.weight"] = _t(src.take("head", "kernel").T)
    sd["head.bias"] = _t(src.take("head", "bias"))
    _check_consumed(src, *([stats] if stats is not None else []))
    return sd


def from_flax_mnist(params) -> Dict[str, torch.Tensor]:
    """flax MnistConvNet ``params`` -> the port's MnistConvNet
    ``state_dict``. ``Dense_0``'s rows are in the NHWC flatten order that
    both models use."""
    src = _Tree(params)
    sd = {}
    for j in range(2):
        sd[f"conv{j}.weight"] = _conv(src.take(f"Conv_{j}", "kernel"))
        sd[f"conv{j}.bias"] = _t(src.take(f"Conv_{j}", "bias"))
        sd[f"dense{j}.weight"] = _t(src.take(f"Dense_{j}", "kernel").T)
        sd[f"dense{j}.bias"] = _t(src.take(f"Dense_{j}", "bias"))
    _check_consumed(src)
    return sd


def _blocks(src: _Tree, tree, sd: Dict[str, torch.Tensor]) -> None:
    """Map every ``EncoderBlock_i`` of ``tree`` onto ``blocks.i``."""
    blocks = sorted(int(m.group(1)) for k in tree
                    if (m := _BLOCK.match(k)))
    if blocks != list(range(len(blocks))):
        raise KeyError(f"EncoderBlock indices are not 0..n-1: {blocks}")
    for i in blocks:
        blk, out = f"EncoderBlock_{i}", f"blocks.{i}"
        for ln_src, ln_dst in (("LayerNorm_0", "ln0"), ("LayerNorm_1", "ln1")):
            _layer_norm(src, (blk, ln_src), f"{out}.{ln_dst}", sd)
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


def _layer_norm(src: _Tree, path, out: str, sd) -> None:
    sd[f"{out}.weight"] = _t(src.take(*path, "scale"))
    sd[f"{out}.bias"] = _t(src.take(*path, "bias"))


def from_flax_params(tree) -> Dict[str, torch.Tensor]:
    """flax GptDecoder params -> the port's GptDecoder ``state_dict``. The
    final LayerNorm is ``LayerNorm_0``."""
    src = _Tree(tree)
    sd = {"embed": _t(src.take("Embed_0", "embedding")),
          "pos_embed": _t(src.take("Embed_1", "embedding"))}
    _blocks(src, tree, sd)
    _layer_norm(src, ("LayerNorm_0",), "ln_f", sd)
    _check_consumed(src)
    return sd


def from_flax_bert(tree) -> Dict[str, torch.Tensor]:
    """flax BertEncoder params -> the port's BertEncoder ``state_dict``.
    BERT's embedding LayerNorm comes first, so flax names it
    ``LayerNorm_0`` and the final one ``LayerNorm_1`` (GPT's final one is
    ``LayerNorm_0``)."""
    src = _Tree(tree)
    sd = {"embed": _t(src.take("Embed_0", "embedding")),
          "pos_embed": _t(src.take("Embed_1", "embedding"))}
    _layer_norm(src, ("LayerNorm_0",), "ln_embed", sd)
    _blocks(src, tree, sd)
    _layer_norm(src, ("LayerNorm_1",), "ln_f", sd)
    sd["lm_bias"] = _t(src.take("lm_bias"))
    _check_consumed(src)
    return sd
