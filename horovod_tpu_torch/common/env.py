"""Environment variables the port reads.

Counterpart of ``horovod_tpu/common/env_registry.py`` (``env_int``,
``env_float``, ``env_bool``), limited to the variables this package reads. Same parsing
rules: unset or empty means the default; a boolean is false for "0",
"false", "no" and "off" (any case) and true for anything else.
"""

from __future__ import annotations

import os

# name -> (default, description)
REGISTRY = {
    "HOROVOD_RANK": (0, "global process rank (launcher contract)"),
    "HOROVOD_SIZE": (1, "number of processes in the job"),
    "HOROVOD_LOCAL_RANK": (0, "rank within this host"),
    "HOROVOD_LOCAL_SIZE": (1, "processes on this host"),
    "HOROVOD_CROSS_RANK": (None, "host index of this process (default: "
                                 "the rank)"),
    "HOROVOD_CROSS_SIZE": (None, "number of hosts (default: the size)"),
    "HOROVOD_HIERARCHICAL_ALLREDUCE": (
        False, "two-level gradient allreduce: reduce-scatter over fsdp, "
               "allreduce over data, all-gather over fsdp"),
    "HOROVOD_BUCKET_BYTES": (
        0, "bound in bytes of one gradient bucket of the train step's "
           "exchange, launched while the backward runs (0: one exchange "
           "after the backward)"),
    "HOROVOD_CYCLE_TIME": (
        1.0, "eager ops: the negotiation loop's cycle time in ms"),
    "HOROVOD_FUSION_THRESHOLD": (
        64 << 20, "eager ops: bound in bytes of one fused allreduce"),
    "HOROVOD_FLASH_MIN_SEQ": (
        256, "key length from which attention routes to the flash kernels "
             "(the crossover measured on an H100)"),
}

_UNSET = object()
_FALSY = ("", "0", "false", "no", "off")


def _raw(name: str):
    if name not in REGISTRY:
        raise KeyError(f"{name} is not a variable horovod_tpu_torch reads; "
                       "declare it in horovod_tpu_torch/common/env.py")
    return os.environ.get(name)


def env_int(name: str, default=_UNSET) -> int:
    """The integer value of registered variable ``name``; ``default`` (or
    the registered default) when it is unset or empty."""
    v = _raw(name)
    if v in (None, ""):
        return REGISTRY[name][0] if default is _UNSET else default
    return int(v)


def env_float(name: str, default=_UNSET) -> float:
    """The float value of registered variable ``name``; ``default`` (or
    the registered default) when it is unset or empty."""
    v = _raw(name)
    if v in (None, ""):
        return float(REGISTRY[name][0] if default is _UNSET else default)
    return float(v)


def env_bool(name: str, default=_UNSET) -> bool:
    """The truth value of registered variable ``name``; ``default`` (or the
    registered default) when it is unset or empty."""
    v = _raw(name)
    if v in (None, ""):
        return bool(REGISTRY[name][0] if default is _UNSET else default)
    return v.strip().lower() not in _FALSY
