"""Environment variables the port reads.

Counterpart of ``horovod_tpu/common/env_registry.py`` (``env_int``,
``env_float``, ``env_bool``, ``env_str``, ``env_is_set``), limited to the
variables this package reads, with the reference's defaults. Same parsing
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
    "HOROVOD_HOSTNAME": ("localhost", "this worker's hostname as the "
                                      "launcher addresses it"),
    "HOROVOD_CONTROLLER_ADDR": (
        "127.0.0.1", "host of rank 0: the TCPStore endpoint of the job's "
                     "process groups (elastic workers)"),
    "HOROVOD_CONTROLLER_PORT": (0, "TCPStore port of the job's process "
                                   "groups (elastic workers)"),
    "HOROVOD_GLOO_TIMEOUT_SECONDS": (
        30.0, "elastic workers: the process groups' timeout, which bounds "
              "how long a collective with a dead or frozen peer waits"),
    "HOROVOD_RENDEZVOUS_ADDR": (None, "launcher's HTTP KV server address "
                                      "(rendezvous)"),
    "HOROVOD_RENDEZVOUS_PORT": (0, "launcher's HTTP KV server port"),
    "HOROVOD_KV_REPLICA_ENDPOINTS": (
        None, "comma-separated host:port list of the KV replica set"),
    "HOROVOD_CONTROL_EPOCH": (
        0, "control epoch the driver spawned this worker into (fencing "
           "floor: strictly-older driver commands are rejected)"),
    "HOROVOD_WORKER_HEARTBEAT_SECONDS": (
        1.0, "elastic worker KV heartbeat interval"),
    "HOROVOD_HEADLESS_DEADLINE_SECONDS": (
        1800.0, "how long a worker keeps training through a driver/KV "
                "outage before aborting (<=0 = never abort)"),
    "HOROVOD_ELASTIC": (False, "this process is an elastic worker"),
    "HOROVOD_ELASTIC_GENERATION": (
        0, "topology generation the driver spawned this worker into"),
    "HOROVOD_ELASTIC_MIN_GENERATION": (
        0, "reject rendezvous info older than this generation (set on "
           "reset)"),
    "HOROVOD_ELASTIC_MAX_RETRIES": (
        100, "bound on HorovodInternalError recovery rounds (0 = "
             "unbounded)"),
    "HOROVOD_ELASTIC_RETRY_BACKOFF_SECONDS": (
        0.5, "base backoff between recovery rounds, doubled (cap 30s) + "
             "jitter"),
    "HOROVOD_PREEMPT_SIGNAL": (
        "SIGTERM", "signal an elastic worker treats as a preemption "
                   "notice"),
    "HOROVOD_PREEMPT_COOLDOWN_SECONDS": (
        300.0, "age past which a shard handoff is stale"),
    "HOROVOD_PREEMPT_HANDOFF": (
        True, "drained workers publish their live ZeRO shard to the "
              "rendezvous KV"),
    "HOROVOD_RESHARD_COMPRESSION": (
        "none", "wire format of the live shard transfer on resize (none | "
                "int8)"),
    "HOROVOD_ELASTIC_SHARD_REDUNDANCY": (
        1, "replicate each rank's committed shard on its ring buddy at "
           "every commit (1); 0 disables"),
    "HOROVOD_FLASH_MIN_SEQ": (
        256, "key length from which attention routes to the flash kernels "
             "(the crossover measured on an H100)"),
    # the serving plane (reference env_registry.py:175-225)
    "HOROVOD_SERVE_PORT": (None, "serving frontend HTTP port (0 = "
                                 "ephemeral; unset = off)"),
    "HOROVOD_SERVE_MAX_BATCH": (
        8, "continuous-batching slot count (max in-flight requests per "
           "step)"),
    "HOROVOD_SERVE_QUEUE_DEPTH": (
        64, "bounded admission queue length; a full queue rejects "
            "(backpressure)"),
    "HOROVOD_SERVE_DEADLINE_MS": (
        1000.0, "default per-request deadline when the client sends none"),
    "HOROVOD_SERVE_MAX_NEW_TOKENS": (32, "cap on generated tokens per "
                                         "request"),
    "HOROVOD_SERVE_ACT_COMPRESSION": (
        "int8", "activation wire format of the tensor-parallel inference "
                "reduction (none | int8, block-quantized)"),
    "HOROVOD_SERVE_DRAIN_TIMEOUT_SECONDS": (
        10.0, "drain grace: how long a departing worker may finish "
              "in-flight requests before they are re-routed"),
    "HOROVOD_SERVE_RETRY_LIMIT": (
        3, "re-route attempts per accepted request before it fails "
           "loudly"),
    "HOROVOD_SERVE_PRIORITY_CLASSES": (
        "batch,standard,premium", "comma-separated priority classes, "
                                  "lowest first; under queue pressure the "
                                  "lowest are shed first"),
    "HOROVOD_SERVE_TENANT_QPS": (
        0.0, "per-tenant token-bucket refill rate in requests/s (0 = "
             "quotas off); exhausted tenants get 429 + Retry-After"),
    "HOROVOD_SERVE_TENANT_BURST": (10.0, "per-tenant token-bucket "
                                         "capacity (burst size)"),
    "HOROVOD_SERVE_KV_BLOCK_TOKENS": (
        16, "token positions covered by one KV-cache block (the paging "
            "granularity and the shareable-prefix quantum)"),
    "HOROVOD_SERVE_KV_POOL_BLOCKS": (
        512, "bounded KV-cache block pool per serving worker; admission "
             "charges worst-case blocks here"),
    "HOROVOD_SERVE_PREFIX_REUSE": (
        True, "hash-based prefix reuse: full prompt blocks are shared "
              "copy-on-write across requests"),
    "HOROVOD_SERVE_SPEC_DECODE": (
        False, "speculative decoding: a draft model proposes "
               "HOROVOD_SERVE_SPEC_DRAFT_K tokens per step and the target "
               "verifies them in one batched step"),
    "HOROVOD_SERVE_SPEC_DRAFT_K": (4, "draft tokens proposed per "
                                      "speculative decode step"),
    # request tracing and the event journal
    "HOROVOD_TRACE_SAMPLE": (
        0.0, "fraction of served requests traced end to end (0 = off)"),
    "HOROVOD_TRACE_DIR": (None, "directory where sampled request traces "
                                "are written as trace_<id>.json"),
    "HOROVOD_TRACE_BUFFER_SPANS": (8192, "in-memory span ring capacity "
                                         "per process"),
    "HOROVOD_JOURNAL_DIR": (None, "durable structured event journal "
                                  "directory (unset = journaling off)"),
    "HOROVOD_JOURNAL_SEGMENT_BYTES": (
        4 << 20, "journal segment size that triggers close-and-rotate"),
    "HOROVOD_JOURNAL_SEGMENTS": (8, "journal segments retained per writer "
                                    "process"),
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


def env_str(name: str, default=_UNSET):
    """The string value of registered variable ``name``; ``default`` (or
    the registered default) when it is unset or empty."""
    v = _raw(name)
    if v in (None, ""):
        return REGISTRY[name][0] if default is _UNSET else default
    return v


def env_is_set(name: str) -> bool:
    """True when registered variable ``name`` is set and non-empty."""
    return _raw(name) not in (None, "")
