"""Parallelism degrees of a job.

Counterpart of ``horovod_tpu/parallel/mesh.py`` (``MeshSpec``,
``AXIS_ORDER``). The reference builds a ``jax.sharding.Mesh`` over devices;
the port runs one process per GPU and reduces over a ``torch.distributed``
process group, so a spec resolves to axis sizes over the world size. Only the
``data`` axis is supported so far: any other axis above 1 raises.
"""

from __future__ import annotations

import dataclasses
import math

# Canonical axis order, as in the reference: slower axes first.
AXIS_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "model")

# The ROADMAP item that ports each axis beyond ``data``.
_ROADMAP_ITEM = {
    "fsdp": "queue A, 'int8 wire and ZeRO-1'",
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
            if axis != "data" and n > 1:
                raise NotImplementedError(
                    f"mesh axis {axis!r}={n}: horovod_tpu_torch supports "
                    f"only the 'data' axis so far; see ROADMAP.md "
                    f"{_ROADMAP_ITEM[axis]}")
        return sizes
