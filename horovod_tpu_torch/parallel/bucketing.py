"""Size-bounded gradient buckets: the layer that overlaps the gradient
exchange with the backward.

Counterpart of ``horovod_tpu/parallel/bucketing.py``. The reference
overlaps by dependency structure inside one XLA program; the port runs
eagerly and overlaps for real: ``parallel/dp.py`` launches a bucket's
collectives (``async_op=True``) from the parameters' post-accumulate
gradient hooks as soon as its last gradient is ready, and waits on every
bucket before the optimizer step.

Rules, as in the reference:

- Buckets are contiguous runs of parameters in REVERSE ``parameters()``
  order (the output side's gradients are ready first in the backward, so
  bucket 0 is the first ready), each bounded by ``bucket_bytes``
  (``HOROVOD_BUCKET_BYTES``); a parameter larger than the bound gets a
  bucket of its own. The plan is a pure function of the shapes and dtypes,
  so every rank derives the same one.
- Within a bucket, tensors fuse per dtype (first-seen order), like
  ``ops/fusion.py``: a bucket costs one collective per dtype it holds.
- With int8 compression every tensor is zero-padded to whole quantization
  blocks (``align=block_size``): blocks never span tensors, so the result
  is the same bits for every bucket bound.

The collectives are elementwise, so for the plain and cast wire formats the
bucketed result equals the unbucketed one bit for bit.

The int8 wire is not elementwise: its blocks group neighbours of the flat
layout. :func:`reference_layout` gives the reference's leaf order (jax's
sorted-key flattening of the flax tree) and per-tensor layout (Dense
kernels ``[in, out]``, conv kernels ``[kh, kw, in, out]``) for a model whose
parameters carry them (``models/convert.py`` tags them); the int8 exchanges
and ZeRO-1 lay the gradients out so, and the blocks then hold the
reference's elements.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from horovod_tpu_torch.common.env import env_int


# how a tensor of each ``models/convert.py`` leaf kind reads in the
# reference's layout, and back: the 2-D kernels transposed, conv kernels
# permuted; the others keep their element order
_TO_REF = {"dense": lambda t: t.t(), "qkv": lambda t: t.t(),
           "out": lambda t: t.t(), "conv": lambda t: t.permute(2, 3, 1, 0)}
_FROM_REF = {"dense": lambda t: t.t(), "qkv": lambda t: t.t(),
             "out": lambda t: t.t(), "conv": lambda t: t.permute(3, 2, 0, 1)}


class Layout(NamedTuple):
    """``order``: tensor positions in the reference's leaf order; ``kinds``:
    per position, the leaf kind that says how the tensor is laid out
    (None: as the reference lays it out)."""
    order: Tuple[int, ...]
    kinds: Tuple[Optional[str], ...]

    @classmethod
    def plain(cls, n: int) -> "Layout":
        """``n`` tensors in their own order and layout."""
        return cls(tuple(range(n)), (None,) * n)

    def to_ref(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Tensor ``t`` of position ``i`` in the reference's layout (a
        view)."""
        fn = _TO_REF.get(self.kinds[i])
        return fn(t) if fn else t

    def from_ref(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`to_ref` (a view)."""
        fn = _FROM_REF.get(self.kinds[i])
        return fn(t) if fn else t


def reference_layout(params: Sequence[torch.Tensor]) -> Layout:
    """The reference's order and layout of ``params`` when every one
    carries its flax leaf (``flax_leaf = (path, kind)``, set by the
    models); otherwise ``params`` as they come."""
    leaves = [getattr(p, "flax_leaf", None) for p in params]
    if not leaves or any(leaf is None for leaf in leaves):
        return Layout.plain(len(leaves))
    return Layout(tuple(sorted(range(len(params)),
                               key=lambda i: leaves[i][0])),
                  tuple(kind for _, kind in leaves))


class Bucket(NamedTuple):
    """One exchange unit: ``indices`` are tensor positions, listed in
    reverse order (about the order their gradients complete)."""
    index: int
    indices: Tuple[int, ...]
    nbytes: int


def resolve_bucket_bytes(bucket_bytes: Optional[int]) -> int:
    """The bucket bound: ``HOROVOD_BUCKET_BYTES`` when None; 0 = off."""
    if bucket_bytes is None:
        bucket_bytes = env_int("HOROVOD_BUCKET_BYTES")
    return max(0, int(bucket_bytes))


def plan_buckets(leaves: Sequence[torch.Tensor],
                 bucket_bytes: int) -> Tuple[Bucket, ...]:
    """Partition ``leaves`` into size-bounded buckets (reference
    bucketing.py:65-86). ``bucket_bytes <= 0`` gives one bucket holding
    everything."""
    nbytes = [t.numel() * t.element_size() for t in leaves]
    order = list(reversed(range(len(leaves))))
    if bucket_bytes <= 0:
        return (Bucket(0, tuple(order), sum(nbytes)),) if leaves else ()
    buckets: List[Bucket] = []
    run: List[int] = []
    run_bytes = 0
    for i in order:
        if run and run_bytes + nbytes[i] > bucket_bytes:
            buckets.append(Bucket(len(buckets), tuple(run), run_bytes))
            run, run_bytes = [], 0
        run.append(i)
        run_bytes += nbytes[i]
    if run:
        buckets.append(Bucket(len(buckets), tuple(run), run_bytes))
    return tuple(buckets)


class Unit(NamedTuple):
    """One fused collective of the exchange: the tensors of one dtype in
    one bucket, or of one dtype over everything without a bound."""
    key: str                  # e.g. "float32", "b0003/float32"
    dtype: torch.dtype
    indices: Tuple[int, ...]  # tensor positions, in fusion order


def _split_dtype(leaves, indices, prefix: str = "") -> List[Unit]:
    order: dict = {}
    for i in indices:
        order.setdefault(leaves[i].dtype, []).append(i)
    return [Unit(prefix + str(dtype).replace("torch.", ""), dtype,
                 tuple(idxs)) for dtype, idxs in order.items()]


def plan_units(leaves: Sequence[torch.Tensor], bucket_bytes: int,
               block_size: int = 1) -> Tuple[List[Unit], int]:
    """``(units, align)``: the exchange units of ``leaves`` and the multiple
    every tensor is zero-padded to inside its unit's flat layout. Without a
    bound, one unit per dtype over all leaves in first-seen order (as
    ``ops/fusion.py`` fuses), unpadded; with one, one unit per (bucket,
    dtype) in bucket order, every tensor padded to whole ``block_size``
    blocks. Every exchange (replicated, ZeRO-1, :func:`bucketed_apply`)
    derives its layout here."""
    if bucket_bytes <= 0:
        return _split_dtype(leaves, range(len(leaves))), 1
    return [u for b in plan_buckets(leaves, bucket_bytes)
            for u in _split_dtype(leaves, b.indices, f"b{b.index:04d}/")], \
        block_size


def plan_units_in(layout: Layout, leaves: Sequence[torch.Tensor],
                  bucket_bytes: int, block_size: int = 1
                  ) -> Tuple[List[Unit], int]:
    """:func:`plan_units` of ``leaves`` taken in ``layout.order``, each
    unit's indices mapped back to positions in ``leaves``."""
    units, align = plan_units([leaves[i] for i in layout.order],
                              bucket_bytes, block_size)
    return [u._replace(indices=tuple(layout.order[j] for j in u.indices))
            for u in units], align


def fuse(xs: Sequence[torch.Tensor], align: int = 1,
         length: Optional[int] = None) -> torch.Tensor:
    """``xs`` flattened and concatenated, each zero-padded to a multiple of
    ``align``, the whole zero-padded to ``length`` if given."""
    parts = []
    for x in xs:
        v = x.reshape(-1)
        pad = (-v.numel()) % align
        parts.append(torch.cat([v, v.new_zeros(pad)]) if pad else v)
    total = sum(p.numel() for p in parts)
    if length is not None and length > total:
        parts.append(parts[0].new_zeros(length - total))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def unfuse(flat: torch.Tensor, shapes: Sequence[torch.Size],
           align: int = 1) -> List[torch.Tensor]:
    """The tensors of :func:`fuse`, cut back out of ``flat`` (views)."""
    out, offset = [], 0
    for shape in shapes:
        n = shape.numel()
        out.append(flat[offset:offset + n].view(shape))
        offset += n + (-n) % align
    return out


def bucketed_apply(fn: Callable[[torch.Tensor], torch.Tensor],
                   xs: Sequence[torch.Tensor], bucket_bytes: int,
                   align: int = 1) -> List[torch.Tensor]:
    """Apply an elementwise collective ``fn`` to ``xs`` in size-bounded
    buckets (reference ``bucketed_apply_tree``): one ``fn`` call per
    :func:`plan_units` unit, each tensor padded to a multiple of ``align``
    when there is a bound."""
    xs = list(xs)
    out: List = [None] * len(xs)
    units, align = plan_units(xs, bucket_bytes, align)
    for unit in units:
        reduced = fn(fuse([xs[i] for i in unit.indices], align))
        for i, r in zip(unit.indices,
                        unfuse(reduced, [xs[i].shape for i in unit.indices],
                               align)):
            out[i] = r
    return out
