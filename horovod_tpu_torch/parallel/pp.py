"""Pipeline parallelism: GPipe-style microbatched stage execution over the
``pipe`` mesh axis.

Counterpart of ``horovod_tpu/parallel/pp.py``. Every rank holds one
stage; activations travel stage to stage with the differentiable
``collectives.ppermute``. The reference's ``lax.scan`` over
``n_micro + n_stages - 1`` ticks becomes a Python loop over the same
ticks: rank s computes microbatch ``t - s`` at tick t, and, as in the
reference, every rank runs its stage on every tick and masks the bubbles.
The masks are ``torch.where``s, not Python branches, so that every rank's
result depends on every hop it sent: then every rank's backward runs the
inverse hop of each, in the same order, and the gradients travel back
through the pipeline as the reference's transposed scan sends them.
"""

from __future__ import annotations

from typing import Callable

import torch

from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.parallel.tp import reduce_from_tp


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor,
                   n_micro: int, axis="pipe") -> torch.Tensor:
    """Run a ``n_stages``-deep pipeline over the ``axis`` mesh dimension.

    ``stage_fn(stage_params, h) -> h`` is this rank's stage (every stage
    keeps the activation's shape and dtype). ``stage_params`` may be a
    tensor, a tree of tensors or an ``nn.Module`` (with ``stage_fn =
    lambda m, h: m(h)``), the counterpart of the reference's stage
    parameter tree. ``x`` is the FULL input batch, split into ``n_micro``
    equal microbatches on dim 0. Returns the full output batch on every
    rank: the last stage's outputs, replicated with ``reduce_from_tp``
    (sum forward, identity backward), so a loss may be taken anywhere.
    """
    n_stages = collectives.axis_size(axis)
    s = collectives.axis_rank(axis)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} must divide into n_micro={n_micro}")
    # activations stay in the caller's dtype (bf16 hops move half the
    # bytes); stage_fn owns any accumulation-precision choices
    micros = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    flag = {v: torch.full((), v, dtype=torch.bool, device=x.device)
            for v in (False, True)}
    is_last = s == n_stages - 1
    zeros = torch.zeros_like(micros[0])
    incoming = zeros
    # the banked outputs, rewritten out of place: an in-place write into a
    # tensor autograd saved would raise or corrupt the saved value
    outputs = [zeros] * n_micro
    ticks = n_micro + n_stages - 1
    for t in range(ticks):
        # stage 0 injects microbatch t (clamped after the last one; the
        # validity mask below drops it)
        h_in = torch.where(flag[s == 0], micros[min(t, n_micro - 1)],
                           incoming)
        h_out = stage_fn(stage_params, h_in)
        micro = t - s
        valid = 0 <= micro < n_micro
        h_out = torch.where(flag[valid], h_out, zeros)
        bank = min(max(micro, 0), n_micro - 1)
        outputs[bank] = torch.where(flag[valid and is_last], h_out,
                                    outputs[bank])
        # forward to the next stage (ring; last -> 0 is ignored); the last
        # tick's hop would arrive after the loop, so it is not sent
        if t < ticks - 1:
            incoming = collectives.ppermute(h_out, perm, axis)
    out = torch.stack(outputs)
    out = reduce_from_tp(torch.where(flag[is_last], out,
                                     torch.zeros_like(out)), axis)
    return out.reshape(b, *x.shape[1:])
