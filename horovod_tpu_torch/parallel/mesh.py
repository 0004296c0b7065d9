"""Parallelism degrees of a job.

Counterpart of ``horovod_tpu/parallel/mesh.py`` (``MeshSpec``,
``AXIS_ORDER``). The reference builds a ``jax.sharding.Mesh`` over devices;
the port runs one process per GPU and reduces over ``torch.distributed``
process groups, so a spec resolves to axis sizes over the world size. The
two replica axes, ``data`` and ``fsdp``, are supported: ranks are laid out
row-major in ``AXIS_ORDER``, so ``fsdp`` is the fast axis. Any other axis
above 1 raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

# Canonical axis order, as in the reference: slower axes first.
AXIS_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "model")

# The replica axes a pure data-parallel step reduces over (reference
# ``dp.DP_AXES``).
REPLICA_AXES = ("data", "fsdp")

# The ROADMAP item that ports each axis beyond the replica axes.
_ROADMAP_ITEM = {
    "model": "queue A, 'Remaining parallelism' (tp)",
    "seq": "queue A, 'Remaining parallelism' (sp)",
    "pipe": "queue A, 'Remaining parallelism' (pp)",
    "expert": "queue A, 'Remaining parallelism' (ep)",
}


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
        for axis, n in sizes.items():
            if axis not in REPLICA_AXES and n > 1:
                raise NotImplementedError(
                    f"mesh axis {axis!r}={n}: horovod_tpu_torch supports "
                    f"only the replica axes {REPLICA_AXES} so far; see "
                    f"ROADMAP.md {_ROADMAP_ITEM[axis]}")
        return sizes


def axis_index(sizes: dict, rank: int, axes: Tuple[str, ...]) -> int:
    """Index of global ``rank`` over the replica axes ``axes``, row-major in
    the order given (``lax.axis_index`` of a tuple in the reference)."""
    coords = {"data": rank // sizes["fsdp"], "fsdp": rank % sizes["fsdp"]}
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


def replica_groups(sizes: dict) -> Dict[Tuple[str, ...], List[List[int]]]:
    """The rank groups of each set of replica axes, for axis sizes from
    :meth:`MeshSpec.resolve`. Ranks are row-major over (data, fsdp): an
    ``fsdp`` group is a run of consecutive ranks sharing a ``data`` index,
    a ``data`` group the strided ranks sharing an ``fsdp`` index, and
    ``("data", "fsdp")`` the whole world. Each group lists its ranks in
    ascending order, which is the axis index order."""
    n_data, n_fsdp = sizes["data"], sizes["fsdp"]
    return {
        ("data",): [[d * n_fsdp + f for d in range(n_data)]
                    for f in range(n_fsdp)],
        ("fsdp",): [[d * n_fsdp + f for f in range(n_fsdp)]
                    for d in range(n_data)],
        REPLICA_AXES: [list(range(n_data * n_fsdp))],
    }
