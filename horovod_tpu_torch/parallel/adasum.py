"""Adasum: scale-invariant gradient combination over the replica axes.

Counterpart of ``horovod_tpu/parallel/adasum.py``: the vector-halving
distance-doubling (VHDD) exchange of the reference's Adasum, over the
port's ``ppermute``. Per pair of gradient vectors (a, b):

    a' = (1 - a.b / (2 ||a||^2)) a + (1 - a.b / (2 ||b||^2)) b

applied over log2(n) levels with partner = index XOR level. At each level a
replica keeps half of its segment and trades the other half with its
partner; the coefficients need the global dot products and norms, so each
replica sums its partial (dot, ||a||^2, ||b||^2) per tensor over its aligned
block of 2 * level replicas (log2 small exchanges); the partials are fp32,
as in the reference. The halving is then unwound, one exchange per level,
and every replica ends with the same result. A tuple axis is the combined
group (``("data", "fsdp")`` is the world). The axis size must be a power of
two, as in the reference; at size 1 the result is the input.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from horovod_tpu_torch.parallel import collectives


def _subgroup_sum(partials: torch.Tensor, axis, level: int,
                  n: int) -> torch.Tensor:
    """``partials`` summed over aligned replica blocks of ``2 * level`` by
    recursive doubling (reference adasum.py:43-53)."""
    step = 1
    while step <= level:
        perm = [(i, i ^ step) for i in range(n)]
        partials = partials + collectives.ppermute(partials, perm, axis)
        step <<= 1
    return partials


def _vhdd_fused(fused: torch.Tensor, tids: torch.Tensor, num_tensors: int,
                axis) -> torch.Tensor:
    """VHDD Adasum of a fused fp32 vector whose length is a multiple of the
    axis size; ``tids`` labels each element with its tensor (the pad is
    tensor ``num_tensors``), so the coefficients stay per tensor
    (reference adasum.py:56-111)."""
    n = collectives.axis_size(axis)
    idx = collectives.axis_rank(axis)
    seg = fused
    level = 1
    while level < n:
        half = seg.shape[0] // 2
        upper = bool(idx & level)
        # the lower replica keeps the first half and sends the second, the
        # upper the reverse; kept and received halves cover the same offsets
        send, keep = (seg[:half], seg[half:]) if upper else \
            (seg[half:], seg[:half])
        tids = tids[half:] if upper else tids[:half]
        recv = collectives.ppermute(send, [(i, i ^ level) for i in range(n)],
                                    axis)
        # a is the lower block's slice, b the upper block's
        a, b = (recv, keep) if upper else (keep, recv)
        prods = torch.stack([a * b, a * a, b * b], dim=-1)
        part = prods.new_zeros(num_tensors + 1, 3).index_add_(0, tids, prods)
        dot, na, nb = _subgroup_sum(part, axis, level, n).unbind(-1)
        # a zero-norm side takes coefficient 1 (the other side unchanged);
        # that also covers the pad, whose values are zero
        ac = torch.where(na == 0, 1.0, 1.0 - dot / (2.0 * na))
        bc = torch.where(nb == 0, 1.0, 1.0 - dot / (2.0 * nb))
        seg = ac[tids] * a + bc[tids] * b
        level <<= 1
    level = n >> 1
    while level >= 1:
        recv = collectives.ppermute(seg, [(i, i ^ level) for i in range(n)],
                                    axis)
        lower, upper_half = (recv, seg) if idx & level else (seg, recv)
        seg = torch.cat([lower, upper_half])
        level >>= 1
    return seg


def _check_axis(axis) -> int:
    n = collectives.axis_size(axis)
    if n & (n - 1):
        raise ValueError(
            f"Adasum requires a power-of-two axis size, got {n} (same "
            "restriction as the reference)")
    return n


def adasum_allreduce_group(xs: Sequence[torch.Tensor],
                           axis=collectives.DEFAULT_AXIS
                           ) -> List[torch.Tensor]:
    """Adasum of a list of tensors in one fused VHDD pass, each tensor with
    its own coefficients (reference adasum.py:123-158): fusing Adasum
    elementwise would give all tensors one coefficient pair, other math.
    Results keep the inputs' shapes and dtypes."""
    xs = list(xs)
    if not xs:
        return []
    n = _check_axis(axis)
    if n == 1:
        return [x.clone() for x in xs]
    sizes = [x.numel() for x in xs]
    total = sum(sizes)
    pad = -total % n
    device = xs[0].device
    fused = torch.cat([x.float().reshape(-1) for x in xs]
                      + [torch.zeros(pad, device=device)])
    tids = torch.repeat_interleave(
        torch.arange(len(xs) + 1, dtype=torch.int32, device=device),
        torch.tensor(sizes + [pad], device=device))
    out = _vhdd_fused(fused, tids, len(xs), axis)
    return [o.view(x.shape).to(x.dtype)
            for o, x in zip(out[:total].split(sizes), xs)]


def adasum_allreduce(x: torch.Tensor,
                     axis=collectives.DEFAULT_AXIS) -> torch.Tensor:
    """VHDD Adasum of one tensor over ``axis``; every replica computes the
    same result (reference adasum.py:161-165)."""
    return adasum_allreduce_group([x], axis)[0]
