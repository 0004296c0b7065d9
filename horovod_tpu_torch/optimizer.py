"""``DistributedOptimizer``: cross-replica gradient reduction around a
``torch.optim`` optimizer.

Counterpart of ``horovod_tpu/jax/__init__.py:63-187``, the optax wrapper.
The reference reduces the gradient tree with ``lax.psum`` over the replica
axes inside ``shard_map``, fused per dtype; the port reduces the
parameters' gradients with the replicated path of ``parallel/dp.py`` over
the same axes: one fused collective per dtype (``bucketing.plan_units``
without a bound), the int8 wire in the reference's leaf order and layout.
A parameter without a gradient reduces as zeros and is stepped, as
``jax.value_and_grad`` gives it a zero gradient.

``step()`` runs every microstep, as optax's ``update`` does: with
``backward_passes_per_step`` > 1 it adds the gradients to an accumulator
the wrapper owns, and only on the boundary scales them (by
``1 / backward_passes_per_step`` with ``average_aggregated_gradients``),
reduces them and steps the inner optimizer; between boundaries the
parameters and the inner state stay as they are (reference :161-185).
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.parallel import collectives, dp
from horovod_tpu_torch.parallel.collectives import Average, Op, Sum


class DistributedOptimizer(torch.optim.Optimizer):
    """Wrap ``optimizer`` so that ``step()`` steps it on the gradients
    reduced over the replicas (reference knobs and refusals, :63-91):

    - ``op``: Average, Sum or Adasum (per-tensor coefficients; compression
      does not apply to it);
    - ``compression``: ``Compression.none``, ``fp16``, ``bf16`` or ``int8``;
    - ``backward_passes_per_step`` and ``average_aggregated_gradients``:
      local accumulation over microsteps before one reduction;
    - ``gradient_predivide_factor`` f: a Sum with prescale 1/f and
      postscale f/n over n replicas, only with ``op=Average``.

    The wrapper shares the inner optimizer's ``param_groups`` and
    ``state``; ``state_dict()`` carries the microstep ``count`` and the
    accumulator beside the inner state. Call after ``init()``."""

    def __init__(self, optimizer: torch.optim.Optimizer, *,
                 op: Op = Average, compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 average_aggregated_gradients: bool = True,
                 gradient_predivide_factor: float = 1.0):
        if gradient_predivide_factor != 1.0 and op is not Average:
            raise ValueError(
                "gradient_predivide_factor supported only with Average")
        bpps = int(backward_passes_per_step)
        if bpps < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        super().__init__(optimizer.param_groups, optimizer.defaults)
        self.optimizer = optimizer
        self.state = optimizer.state
        self.backward_passes_per_step = bpps
        self.average_aggregated_gradients = average_aggregated_gradients
        self._params = [p for g in self.param_groups for p in g["params"]]
        pre = post = 1.0
        if gradient_predivide_factor != 1.0:
            n = collectives.axis_size(dp.DP_AXES)
            op, pre, post = Sum, 1.0 / gradient_predivide_factor, \
                gradient_predivide_factor / n
        self._exchange = dp.replicated_exchange(
            self._params, op, dp._check_compression(compression), pre, post,
            hierarchical=False, bucket_bytes=0)
        self.count = 0
        self.accum = [torch.zeros_like(p) for p in self._params] \
            if bpps > 1 else []

    @torch.no_grad()
    def _reduce_and_step(self) -> None:
        self._exchange.begin()
        for _, idxs, grads in self._exchange.finish():
            for i, g in zip(idxs, grads):
                self._params[i].grad = g
        self.optimizer.step()

    @torch.no_grad()
    def step(self, closure=None):
        """One microstep: on the boundary, reduce and step the inner
        optimizer; otherwise accumulate. Returns ``closure()``'s loss."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.count += 1
        if self.backward_passes_per_step == 1:
            self._reduce_and_step()
            return loss
        for p, acc in zip(self._params, self.accum):
            if p.grad is not None:
                acc.add_(p.grad)
        if self.count % self.backward_passes_per_step == 0:
            scale = 1.0 / self.backward_passes_per_step \
                if self.average_aggregated_gradients else 1.0
            for p, acc in zip(self._params, self.accum):
                p.grad = acc * scale
            self._reduce_and_step()
            for acc in self.accum:
                acc.zero_()
        return loss

    def state_dict(self) -> dict:
        return {"count": self.count,
                "accum": [a.clone() for a in self.accum],
                "inner": self.optimizer.state_dict()}

    def load_state_dict(self, state_dict: dict) -> None:
        self.optimizer.load_state_dict(state_dict["inner"])
        self.count = int(state_dict["count"])
        with torch.no_grad():
            for acc, saved in zip(self.accum, state_dict["accum"]):
                acc.copy_(saved)

