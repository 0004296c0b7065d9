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

One table per model (``gpt_entries``, ``bert_entries``, ``mnist_entries``,
``resnet_entries``) lists every leaf as ``(flax path, port key, kind)``.
The converters read it, and each model tags its parameters with it
(:func:`tag_leaves`), which gives the gradient exchange the reference's
leaf order and layout (``parallel/bucketing.reference_layout``).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

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
    blocks = [(kind, "conv_proj" in params[f"{kind}_{i}"])
              for kind, i in _indices(params, _RESNET_BLOCK)]
    entries, norms = resnet_entries(blocks)
    sd = _convert(src, entries)
    trees = [src]
    if batch_stats is not None:
        stats = _Tree(batch_stats)
        for path, key in norms:
            sd[f"{key}.mean"] = _t(stats.take(*path, "mean"))
            sd[f"{key}.var"] = _t(stats.take(*path, "var"))
        trees.append(stats)
    _check_consumed(*trees)
    return sd


def from_flax_mnist(params) -> Dict[str, torch.Tensor]:
    """flax MnistConvNet ``params`` -> the port's MnistConvNet
    ``state_dict``. ``Dense_0``'s rows are in the NHWC flatten order that
    both models use."""
    src = _Tree(params)
    sd = _convert(src, mnist_entries())
    _check_consumed(src)
    return sd


# how a flax leaf of each kind becomes the port's tensor: Dense kernels
# [in, out] -> [out, in]; attention kernels [d, h, hd] -> [h * hd, d] and
# [h, hd, d] -> [d, h * hd]; attention biases [h, hd] -> [h * hd]
_TO_PORT = {"same": lambda a: a, "dense": lambda a: a.T,
            "qkv": lambda a: a.reshape(a.shape[0], -1).T,
            "out": lambda a: a.reshape(-1, a.shape[-1]).T,
            "flat": lambda a: a.reshape(-1),
            "conv": lambda a: np.transpose(a, (3, 2, 0, 1))}


def _dense(path, key):
    return [(path + ("kernel",), f"{key}.weight", "dense"),
            (path + ("bias",), f"{key}.bias", "same")]


def _layer_norm(path, key):
    return [(path + ("scale",), f"{key}.weight", "same"),
            (path + ("bias",), f"{key}.bias", "same")]


def _block_entries(attns) -> list:
    """``(flax path, port key, kind)`` of every ``EncoderBlock_i``, with
    ``attns[i]`` the name flax gave block i's attention module."""
    out = []
    for i, attn in enumerate(attns):
        blk, key = (f"EncoderBlock_{i}",), f"blocks.{i}"
        out += _layer_norm(blk + ("LayerNorm_0",), f"{key}.ln0")
        out += _layer_norm(blk + ("LayerNorm_1",), f"{key}.ln1")
        for name in ("query", "key", "value"):
            path = blk + (attn, name)
            out += [(path + ("kernel",), f"{key}.attn.{name}.weight", "qkv"),
                    (path + ("bias",), f"{key}.attn.{name}.bias", "flat")]
        out += [(blk + (attn, "out", "kernel"), f"{key}.attn.out.weight",
                 "out"),
                (blk + (attn, "out", "bias"), f"{key}.attn.out.bias",
                 "same")]
        out += _dense(blk + ("Dense_0",), f"{key}.mlp0")
        out += _dense(blk + ("Dense_1",), f"{key}.mlp1")
    return out


def _embeddings():
    return [(("Embed_0", "embedding"), "embed", "same"),
            (("Embed_1", "embedding"), "pos_embed", "same")]


def gpt_entries(attns) -> list:
    """The GptDecoder's leaves: ``(flax path, port key, kind)``. The final
    LayerNorm is ``LayerNorm_0``."""
    return _embeddings() + _block_entries(attns) + \
        _layer_norm(("LayerNorm_0",), "ln_f")


def bert_entries(attns) -> list:
    """The BertEncoder's leaves. BERT's embedding LayerNorm comes first,
    so flax names it ``LayerNorm_0`` and the final one ``LayerNorm_1``."""
    return _embeddings() + _layer_norm(("LayerNorm_0",), "ln_embed") + \
        _block_entries(attns) + _layer_norm(("LayerNorm_1",), "ln_f") + \
        [(("lm_bias",), "lm_bias", "same")]


def mnist_entries() -> list:
    """The MnistConvNet's leaves."""
    out = []
    for j in range(2):
        out += [((f"Conv_{j}", "kernel"), f"conv{j}.weight", "conv"),
                ((f"Conv_{j}", "bias"), f"conv{j}.bias", "same")]
        out += _dense((f"Dense_{j}",), f"dense{j}")
    return out


def _norm_entries(path, key):
    return [(path + ("scale",), f"{key}.scale", "same"),
            (path + ("bias",), f"{key}.bias", "same")]


def resnet_entries(blocks) -> Tuple[list, list]:
    """``(parameter leaves, BatchNorm paths)`` of a ResNet whose blocks
    are ``blocks``: ``(kind, has_projection)`` each, ``kind`` the block
    class's name. A BatchNorm path is ``(flax path, port key)``; its
    ``mean`` and ``var`` live in ``batch_stats``."""
    norms = [(("bn_init",), "bn_init")]
    params = [(("conv_init", "kernel"), "conv_init.weight", "conv")]
    for i, (kind, proj) in enumerate(blocks):
        blk, key = (f"{kind}_{i}",), f"blocks.{i}"
        for j in range(_RESNET_CONVS[kind]):
            params.append((blk + (f"Conv_{j}", "kernel"),
                           f"{key}.conv{j}.weight", "conv"))
            norms.append((blk + (f"BatchNorm_{j}",), f"{key}.bn{j}"))
        if proj:
            params.append((blk + ("conv_proj", "kernel"),
                           f"{key}.conv_proj.weight", "conv"))
            norms.append((blk + ("norm_proj",), f"{key}.norm_proj"))
    for path, key in norms:
        params += _norm_entries(path, key)
    return params + _dense(("head",), "head"), norms


def _convert(src: _Tree, entries) -> Dict[str, torch.Tensor]:
    return {key: _t(_TO_PORT[kind](src.take(*path)))
            for path, key, kind in entries}


def tag_leaves(module: nn.Module, entries) -> None:
    """Give each parameter of ``module`` named in ``entries`` its flax leaf
    as ``flax_leaf = (path, kind)``: the reference's leaf order and layout
    that ``parallel/bucketing.reference_layout`` reads."""
    for path, key, kind in entries:
        module.get_parameter(key).flax_leaf = (path, kind)


def _attns(tree) -> list:
    """The attention module name of every ``EncoderBlock_i`` of ``tree``;
    the indices must be 0..n-1."""
    blocks = sorted(int(m.group(1)) for k in tree
                    if (m := _BLOCK.match(k)))
    if blocks != list(range(len(blocks))):
        raise KeyError(f"EncoderBlock indices are not 0..n-1: {blocks}")
    return [next((a for a in _ATTN if a in tree[f"EncoderBlock_{i}"]),
                 _ATTN[0]) for i in blocks]


def from_flax_params(tree) -> Dict[str, torch.Tensor]:
    """flax GptDecoder params -> the port's GptDecoder ``state_dict``."""
    src = _Tree(tree)
    sd = _convert(src, gpt_entries(_attns(tree)))
    _check_consumed(src)
    return sd


def from_flax_bert(tree) -> Dict[str, torch.Tensor]:
    """flax BertEncoder params -> the port's BertEncoder ``state_dict``."""
    src = _Tree(tree)
    sd = _convert(src, bert_entries(_attns(tree)))
    _check_consumed(src)
    return sd
