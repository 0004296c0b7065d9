"""Environment variables the port reads.

Counterpart of ``horovod_tpu/common/env_registry.py`` (``env_int``),
limited to the variables this package reads, all integers so far. Same
parsing rule: unset or empty means the default.
"""

from __future__ import annotations

import os

# name -> (default, description)
REGISTRY = {
    "HOROVOD_RANK": (0, "global process rank (launcher contract)"),
    "HOROVOD_SIZE": (1, "number of processes in the job"),
    "HOROVOD_LOCAL_RANK": (0, "rank within this host"),
    "HOROVOD_FLASH_MIN_SEQ": (
        256, "key length from which attention routes to the flash kernels "
             "(the crossover measured on an H100)"),
}

_UNSET = object()


def env_int(name: str, default=_UNSET) -> int:
    """The integer value of registered variable ``name``; ``default`` (or
    the registered default) when it is unset or empty."""
    if name not in REGISTRY:
        raise KeyError(f"{name} is not a variable horovod_tpu_torch reads; "
                       "declare it in horovod_tpu_torch/common/env.py")
    v = os.environ.get(name)
    if v in (None, ""):
        return REGISTRY[name][0] if default is _UNSET else default
    return int(v)
