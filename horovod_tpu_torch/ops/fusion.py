"""Tensor fusion: many small collectives become one per dtype.

Counterpart of ``horovod_tpu/ops/fusion.py`` (``fused_apply``,
``fused_apply_tree``). Tensors are flattened and concatenated per dtype, one
collective runs on each concatenation, and the results are cut back to the
original shapes. On the card each concatenation is one NCCL call instead of
one per gradient.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch


def fused_apply(fn: Callable[[torch.Tensor], torch.Tensor],
                xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Apply an elementwise, shape-preserving ``fn`` to all of ``xs``, fused
    per dtype (stable grouping, in first-seen order)."""
    xs = list(xs)
    if not xs:
        return []
    if len(xs) == 1:
        return [fn(xs[0])]
    groups: dict = {}
    for i, x in enumerate(xs):
        groups.setdefault(x.dtype, []).append(i)
    out: List = [None] * len(xs)
    for idxs in groups.values():
        if len(idxs) == 1:
            out[idxs[0]] = fn(xs[idxs[0]])
            continue
        reduced = fn(torch.cat([xs[i].reshape(-1) for i in idxs]))
        offset = 0
        for i in idxs:
            n = xs[i].numel()
            out[i] = reduced[offset:offset + n].view(xs[i].shape)
            offset += n
    return out


def map_tree(fn: Callable, tree):
    """``fn`` applied to every leaf of nested dicts, lists and tuples,
    keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def fused_apply_tree(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """``fused_apply`` over the tensors of nested dicts, lists and tuples,
    keeping the structure."""
    leaves: list = []
    map_tree(leaves.append, tree)
    out = iter(fused_apply(fn, leaves))
    return map_tree(lambda _: next(out), tree)
