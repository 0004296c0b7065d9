"""Parallelism degrees of a job.

Counterpart of ``horovod_tpu/parallel/mesh.py`` (``MeshSpec``,
``AXIS_ORDER``). The reference builds a ``jax.sharding.Mesh`` over devices;
the port runs one process per GPU and reduces over ``torch.distributed``
process groups, so a spec resolves to axis sizes over the world size. Ranks
are laid out row-major in ``AXIS_ORDER``, as the reference's ``build_mesh``
reshapes its device list (``horovod_tpu/parallel/mesh.py:83-86``): ``model``
is the fastest axis, ``pipe`` the slowest, and rank r sits where the
reference puts ``devices[r]``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Tuple

# Canonical axis order, as in the reference: slower axes first.
AXIS_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "model")

# The replica axes a pure data-parallel step reduces over (reference
# ``dp.DP_AXES``).
REPLICA_AXES = ("data", "fsdp")

# The sets of replica axes that always get a group of their own.
REPLICA_SETS = (("data",), ("fsdp",), REPLICA_AXES)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism degrees. -1 on ``data`` means "all remaining"."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> dict:
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        fixed = math.prod(v for v in sizes.values() if v != -1)
        n_wild = sum(1 for v in sizes.values() if v == -1)
        if n_wild > 1:
            raise ValueError("at most one mesh axis may be -1")
        if n_wild == 1:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by "
                                 f"fixed axes product {fixed}")
            wild = n_devices // fixed
            sizes = {k: (wild if v == -1 else v) for k, v in sizes.items()}
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes


def coords(sizes: dict, rank: int) -> dict:
    """Coordinate of global ``rank`` on every axis (row-major in
    ``AXIS_ORDER``; an axis missing from ``sizes`` has size 1)."""
    out = {}
    for a in reversed(AXIS_ORDER):
        n = sizes.get(a, 1)
        out[a] = rank % n
        rank //= n
    return out


def axis_index(sizes: dict, rank: int, axes: Tuple[str, ...]) -> int:
    """Index of global ``rank`` over ``axes``, row-major in the order given
    (``lax.axis_index`` of a tuple in the reference)."""
    c = coords(sizes, rank)
    idx = 0
    for a in axes:
        idx = idx * sizes.get(a, 1) + c[a]
    return idx


def axis_groups(sizes: dict, axes: Tuple[str, ...]) -> List[List[int]]:
    """The rank groups of ``axes``: one per coordinate of the other axes,
    each the ranks that differ only on ``axes``, in ascending order, which
    is the axis index order over ``axes`` taken in ``AXIS_ORDER``. No axes
    gives every rank a group of its own."""
    world = math.prod(sizes.get(a, 1) for a in AXIS_ORDER)
    others = [a for a in AXIS_ORDER if a not in axes]
    groups: Dict[tuple, List[int]] = {}
    for r in range(world):
        c = coords(sizes, r)
        groups.setdefault(tuple(c[a] for a in others), []).append(r)
    return list(groups.values())


def replica_groups(sizes: dict) -> Dict[Tuple[str, ...], List[List[int]]]:
    """The rank groups of each set of replica axes: an ``fsdp`` group is a
    run of ranks sharing every other coordinate, a ``data`` group the
    strided ranks sharing an ``fsdp`` index, and ``("data", "fsdp")`` both.
    """
    return {axes: axis_groups(sizes, axes)
            for axes in REPLICA_SETS}


def group_sets(sizes: dict) -> List[Tuple[str, ...]]:
    """The sets of axes that get a process group, in the order every rank
    creates them: the replica sets, whatever their sizes (the gradient
    exchange runs through the backend even at world 1), then every other
    subset of the axes longer than 1 (a set's group equals the group of its
    axes longer than 1, so these cover every set a module can name without
    making all 63), then ``()``, every rank alone, the group of a set whose
    axes all have size 1."""
    long = [a for a in AXIS_ORDER if sizes.get(a, 1) > 1]
    out = list(REPLICA_SETS)
    for n in range(1, len(long) + 1):
        out += [s for s in itertools.combinations(long, n) if s not in out]
    return out + [()]


def group_key(sizes: dict, axes: Tuple[str, ...]) -> Tuple[str, ...]:
    """The set of :func:`group_sets` whose group is that of ``axes``
    (canonical, in ``AXIS_ORDER``)."""
    if axes in REPLICA_SETS:
        return axes
    return tuple(a for a in axes if sizes.get(a, 1) > 1)
