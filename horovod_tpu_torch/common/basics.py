"""Process context: init/shutdown/rank/size/local_rank and the host
topology (local_size, cross_rank, cross_size).

Counterpart of ``horovod_tpu/common/basics.py``. Topology comes from the same
launcher env contract (``HOROVOD_RANK``, ``HOROVOD_SIZE``,
``HOROVOD_LOCAL_RANK``, ``HOROVOD_LOCAL_SIZE``, ``HOROVOD_CROSS_RANK``,
``HOROVOD_CROSS_SIZE``; reference basics.py:76-82). Where the reference
builds a device mesh, the port runs one process per GPU and creates a
``torch.distributed`` process group: NCCL on the card, gloo for
``device="cpu"``. The group exists even at world size 1, so the gradient
allreduce always runs through the same backend. ``init()`` also creates the
subgroups of the mesh spec's axes that the collectives map their ``axis``
argument to (``parallel/mesh.py`` ``group_sets``), and the two groups of the
eager ops (``common/eager.py``): a gloo control group for the name
negotiation and a data group on the step's backend, apart from the default
group so that an eager launch never interleaves with the step's
collectives on one communicator.
"""

from __future__ import annotations

import math
import os
import threading
from datetime import timedelta
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.env import env_int
from horovod_tpu_torch.parallel.mesh import (AXIS_ORDER, REPLICA_AXES,
                                             MeshSpec, axis_groups,
                                             axis_index, group_key,
                                             group_sets)


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda:local_rank``; without CUDA that raises unless
    the caller asks for the CPU explicitly (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda", env_int("HOROVOD_LOCAL_RANK"))


class _Context:
    """Singleton process context."""

    def __init__(self):
        self._lock = threading.Lock()
        self.initialized = False
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.cross_rank = 0
        self.cross_size = 1
        self.device: Optional[torch.device] = None
        # a set of axes of group_sets -> (process group, None for the
        # whole world; the group's global ranks in ascending order)
        self.groups: dict = {}
        self.sizes: dict = {}  # axis -> size
        # the eager ops' process groups: (gloo control, data)
        self.eager_groups: Optional[tuple] = None

    def init(self, device=None, mesh_spec: Optional[MeshSpec] = None,
             store: Optional[dist.Store] = None,
             timeout: timedelta = timedelta(minutes=5)):
        with self._lock:
            if self.initialized:
                return
            dev = resolve_device(device)
            rank = env_int("HOROVOD_RANK")
            size = env_int("HOROVOD_SIZE")
            local_rank = env_int("HOROVOD_LOCAL_RANK")
            sizes = (mesh_spec or MeshSpec()).resolve(size)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
                backend = "nccl"
            elif dev.type == "cpu":
                backend = "gloo"
            else:
                raise ValueError(f"unsupported device {dev}")
            if store is None:
                store = _default_store(rank, size, timeout)
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=size, timeout=timeout)
            self.rank, self.size, self.local_rank = rank, size, local_rank
            self.local_size = env_int("HOROVOD_LOCAL_SIZE")
            self.cross_rank = env_int("HOROVOD_CROSS_RANK", rank)
            self.cross_size = env_int("HOROVOD_CROSS_SIZE", size)
            self.groups = _axis_groups(sizes, rank)
            # collective: every rank creates both, in this order. A rank
            # that has joined waits in a negotiation round while the
            # others train on for as long as their data lasts: the
            # control group waits a day, not the data groups' timeout
            self.eager_groups = (
                dist.new_group(backend="gloo", timeout=timedelta(days=1)),
                dist.new_group(backend=backend))
            self.sizes = sizes
            self.device = dev
            self.initialized = True

    def shutdown(self):
        with self._lock:
            if not self.initialized:
                return
            from horovod_tpu_torch.common import eager
            eager.stop_executor()
            dist.destroy_process_group()
            self.initialized = False
            self.device = None
            self.groups = {}
            self.sizes = {}
            self.eager_groups = None


def _axis_groups(sizes: dict, rank: int) -> dict:
    """This rank's process group for each set of axes of ``group_sets``. A
    set whose one group is the whole world uses the default group; the
    others are created with ``new_subgroups_by_enumeration``, which every
    rank calls for every set, in the same order, as ``torch.distributed``
    requires. Sets that split the ranks alike share one."""
    out, made = {}, {}
    for axes in group_sets(sizes):
        groups = axis_groups(sizes, axes)
        mine = next(g for g in groups if rank in g)
        if len(groups) == 1:
            out[axes] = (None, mine)
            continue
        key = tuple(map(tuple, groups))
        if key not in made:
            made[key] = dist.new_subgroups_by_enumeration(groups)[0]
        out[axes] = (made[key], mine)
    return out


def _default_store(rank: int, size: int, timeout: timedelta) -> dist.Store:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if addr and port:
        return dist.TCPStore(addr, int(port), size, is_master=rank == 0,
                             timeout=timeout)
    if size == 1:
        return dist.HashStore()
    raise ValueError(
        f"world size {size} needs a rendezvous: set MASTER_ADDR and "
        "MASTER_PORT, or pass store=")


_ctx = _Context()


def init(device=None, mesh_spec: Optional[MeshSpec] = None,
         store: Optional[dist.Store] = None) -> None:
    """Join the job. ``device=None`` runs on ``cuda:local_rank`` and raises
    when CUDA is absent; ``device="cpu"`` runs on gloo. ``store`` overrides
    the rendezvous (default: ``MASTER_ADDR``/``MASTER_PORT``, or a local
    store at world size 1)."""
    _ctx.init(device=device, mesh_spec=mesh_spec, store=store)


def shutdown() -> None:
    _ctx.shutdown()


def is_initialized() -> bool:
    return _ctx.initialized


def _require_init():
    if not _ctx.initialized:
        raise ValueError("horovod_tpu_torch has not been initialized; "
                         "call horovod_tpu_torch.init()")


def rank() -> int:
    _require_init()
    return _ctx.rank


def size() -> int:
    _require_init()
    return _ctx.size


def local_rank() -> int:
    _require_init()
    return _ctx.local_rank


def local_size() -> int:
    _require_init()
    return _ctx.local_size


def cross_rank() -> int:
    _require_init()
    return _ctx.cross_rank


def cross_size() -> int:
    _require_init()
    return _ctx.cross_size


def num_replicas() -> int:
    """Total data-parallel replicas (reference basics.py:340-357): the
    product of the replica axes' sizes. It is the world size only when
    ``model``, ``seq``, ``pipe`` and ``expert`` all have size 1."""
    _require_init()
    return math.prod(_ctx.sizes[a] for a in REPLICA_AXES)


def axis_group(axes: Tuple[str, ...]) -> Tuple[Optional[dist.ProcessGroup],
                                               List[int]]:
    """The process group of mesh axes ``axes`` (each named once, in any
    order) that holds this rank, ``None`` for the whole world, and its
    global ranks in axis index order: row-major over ``axes`` in the order
    given, as ``lax.axis_index`` of a tuple. The group is the same set of
    ranks whatever the order; only the order of the list changes."""
    _require_init()
    canonical = tuple(sorted(axes, key=AXIS_ORDER.index))
    group, ranks = _ctx.groups[group_key(_ctx.sizes, canonical)]
    if axes != canonical:
        ranks = sorted(ranks, key=lambda r: axis_index(_ctx.sizes, r, axes))
    return group, ranks


def device() -> torch.device:
    """The device this process was initialized on."""
    _require_init()
    return _ctx.device
