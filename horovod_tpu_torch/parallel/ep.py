"""Expert parallelism: a GShard-style Mixture-of-Experts layer over the
``expert`` mesh axis.

Counterpart of ``horovod_tpu/parallel/ep.py``:

- **top-1 capacity routing** with static shapes: each token picks its
  highest-gate expert (the first on ties, as ``jnp.argmax`` does); a
  cumulative-sum position assigns it a slot in that expert's
  fixed-capacity buffer. Tokens past capacity are dropped (their combine
  weight is zero).
- **all-to-all dispatch**: the [experts, capacity, d] buffers exchange
  over the ``expert`` axis with one differentiable ``collectives.alltoall``
  each way.
- **expert-sharded parameters**: each rank holds ``E_total / n_ep`` expert
  MLPs; gate weights are replicated.

Shapes (per rank): tokens ``[T_local, d]``; w_gate ``[d, E_total]``
(replicated); w_in ``[E_local, d, hidden]``, w_out ``[E_local, hidden,
d]`` (sharded over ``expert``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.parallel.tp import gelu_tanh


def top1_dispatch(gates: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build dispatch/combine tensors for top-1 routing.

    gates: [T, E] softmax router probabilities. Returns
    (dispatch [T, E, C] one-hot, combine [T, E, C] = dispatch * gate_prob)
    in the gates' dtype. Token t goes to expert argmax(gates[t]) at slot
    ``position-in-expert``; tokens whose slot >= capacity are dropped
    (all-zero rows)."""
    t, e = gates.shape
    expert_idx = torch.argmax(gates, dim=-1)  # [T], first maximum
    onehot = F.one_hot(expert_idx, e).to(torch.int32)  # [T, E]
    # 0-based position of each token within its expert's arrival order
    # (cumsum counts the token itself, so subtract the onehot back out)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) * onehot - onehot
    slot = pos.sum(-1, dtype=torch.int32)  # [T]
    keep = slot < capacity
    slot = torch.where(keep, slot, capacity).long()
    dispatch = (onehot.to(gates.dtype)[:, :, None] *
                F.one_hot(slot, capacity + 1).to(gates.dtype)
                [:, None, :capacity])
    prob = gates.amax(-1)  # [T]
    combine = dispatch * prob[:, None, None]
    return dispatch, combine


def moe_layer(x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
              w_out: torch.Tensor, axis="expert",
              capacity_factor: float = 1.25,
              activation=gelu_tanh) -> torch.Tensor:
    """One expert-parallel MoE feed-forward layer (every rank of ``axis``
    calls it on its own tokens).

    x: [T_local, d]; w_gate: [d, E_total] replicated; w_in/w_out:
    [E_local, d, h] / [E_local, h, d] sharded over ``axis``. Returns
    [T_local, d] — each token's output is its top-1 expert's MLP output
    scaled by the gate probability (dropped tokens produce zeros, as in
    GShard/Switch). The router and experts run in fp32.
    """
    n_ep = collectives.axis_size(axis)
    t_loc, d = x.shape
    e_loc = w_in.shape[0]
    e_total = n_ep * e_loc
    if w_gate.shape[-1] != e_total:
        raise ValueError(
            f"w_gate routes to {w_gate.shape[-1]} experts but the mesh "
            f"provides {n_ep} ranks x {e_loc} local = {e_total}")
    # per (source rank, expert) capacity
    capacity = max(1, int(capacity_factor * t_loc / e_total))

    xf = x.float()
    gates = torch.softmax(xf @ w_gate.float(), dim=-1)
    dispatch, combine = top1_dispatch(gates, capacity)  # [T, E, C]

    # gather tokens into expert buffers: [E_total, C, d]
    expert_in = torch.einsum("tec,td->ecd", dispatch, xf)
    # exchange over the expert axis: each rank ends with its local
    # experts' tokens from every source rank, regrouped to
    # [E_local, n_ep * C, d]
    expert_in = collectives.alltoall(expert_in, axis)
    expert_in = expert_in.reshape(n_ep, e_loc, capacity, d) \
        .transpose(0, 1).reshape(e_loc, n_ep * capacity, d)

    h = activation(torch.einsum("esd,edh->esh", expert_in, w_in.float()))
    expert_out = torch.einsum("esh,ehd->esd", h, w_out.float())

    # reverse exchange: back to [E_total, C, d] on the source ranks
    expert_out = expert_out.reshape(e_loc, n_ep, capacity, d) \
        .transpose(0, 1).reshape(e_total, capacity, d)
    expert_out = collectives.alltoall(expert_out, axis)

    out = torch.einsum("tec,ecd->td", combine, expert_out)
    return out.to(x.dtype)
