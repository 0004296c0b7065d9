"""Broadcast and gather helpers for parameters, optimizer state and Python
objects.

Counterpart of ``horovod_tpu/jax/functions.py``, built on the eager ops of
``mpi_ops.py``: every tensor is submitted at once and then synchronized, so
the negotiation fuses and pipelines them. Objects travel as pickled bytes in
uint8 tensors on the device: a size broadcast (or allgather), then the
payload.
"""

from __future__ import annotations

import pickle
from typing import Any, List, NamedTuple, Optional

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch import mpi_ops


def _tensors(params) -> List[torch.Tensor]:
    """The tensors of a ``state_dict`` (or any mapping), or of an iterable
    of tensors or ``(name, tensor)`` pairs."""
    items = params.values() if hasattr(params, "values") else params
    values = [v[1] if isinstance(v, tuple) else v for v in items]
    return [v for v in values if isinstance(v, torch.Tensor)]


@torch.no_grad()
def broadcast_parameters(params, root_rank: int = 0):
    """Overwrite every tensor of ``params`` (a ``state_dict``, or an
    iterable of tensors or ``(name, tensor)`` pairs) in place with
    ``root_rank``'s (reference functions.py:21-33); returns ``params``."""
    tensors = _tensors(params)
    handles = [mpi_ops.broadcast_async(t, root_rank, name=f"bcast_params.{i}")
               for i, t in enumerate(tensors)]
    for t, h in zip(tensors, handles):
        t.copy_(mpi_ops.synchronize(h))
    return params


class _Spec(NamedTuple):
    """A tensor of the root's optimizer state, by shape and placement."""
    shape: tuple
    dtype: torch.dtype
    on_cpu: bool


def _flatten(tree, out: list):
    """``tree`` with every tensor replaced by its :class:`_Spec`; the
    tensors appended to ``out`` in traversal order."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return _Spec(tuple(tree.shape), tree.dtype, tree.device.type == "cpu")
    if isinstance(tree, dict):
        return {k: _flatten(v, out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, out) for v in tree)
    return tree


def _fill(tree, tensors):
    if isinstance(tree, _Spec):
        return next(tensors)
    if isinstance(tree, dict):
        return {k: _fill(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, tensors) for v in tree)
    return tree


def _specs(tree, out: list) -> list:
    """The :class:`_Spec` leaves of ``tree`` in traversal order."""
    if isinstance(tree, _Spec):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _specs(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _specs(v, out)
    return out


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Load ``root_rank``'s optimizer state into ``optimizer`` on every
    rank (reference functions.py:36-53): its layout and Python scalars
    (hyperparameters, step counts held as numbers) through
    :func:`broadcast_object`, its tensors through the eager broadcast.
    Every rank takes the root's layout, so a rank that has not stepped yet
    gets the root's moments too."""
    tensors: list = []
    skeleton = broadcast_object(_flatten(optimizer.state_dict(), tensors),
                                root_rank, name="bcast_opt_state_py")
    if basics.is_initialized() and basics.rank() != root_rank:
        tensors = [torch.zeros(s.shape, dtype=s.dtype, device="cpu"
                               if s.on_cpu else basics.device())
                   for s in _specs(skeleton, [])]
    broadcast_parameters(tensors, root_rank)
    optimizer.load_state_dict(_fill(skeleton, iter(tensors)))


def _payload(obj) -> torch.Tensor:
    return torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)


def _unpickle(data: torch.Tensor):
    return pickle.loads(data.cpu().numpy().tobytes())


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """``root_rank``'s ``obj`` on every rank, pickled (reference
    functions.py:56-75: a size broadcast, then the payload)."""
    name = name or "broadcast_object"
    if not basics.is_initialized():
        return obj
    root = basics.rank() == root_rank
    payload = _payload(obj) if root else torch.zeros(0, dtype=torch.uint8)
    size = mpi_ops.broadcast(torch.tensor([payload.numel()]), root_rank,
                             name=name + ".sz")
    if not root:
        payload = torch.zeros(int(size[0]), dtype=torch.uint8)
    return _unpickle(mpi_ops.broadcast(payload, root_rank,
                                       name=name + ".data"))


def allgather_object(obj: Any, name: Optional[str] = None) -> list:
    """One ``obj`` per rank, in rank order (reference functions.py:78-98):
    the byte counts through a fixed-size allgather, the pickles through
    the ragged one."""
    name = name or "allgather_object"
    if not basics.is_initialized():
        return [obj]
    payload = _payload(obj)
    sizes = mpi_ops.allgather(torch.tensor([payload.numel()]),
                              name=name + ".sz").tolist()
    data = mpi_ops.allgather(payload, name=name + ".data")
    out, offset = [], 0
    for n in sizes:
        out.append(_unpickle(data[offset:offset + n]))
        offset += n
    return out
