"""Environment variables the port reads.

Counterpart of ``horovod_tpu/common/env_registry.py`` (``env_int``,
``env_float``, ``env_bool``, ``env_str``, ``env_is_set``,
``render_env_table``), limited to the variables this package reads or sets
for the processes it starts, with the reference's defaults. Same parsing
rules: unset or empty means the default; a boolean is false for "0",
"false", "no" and "off" (any case) and true for anything else. Lint rules
HVL004-HVL006 (``horovod_tpu_torch/lint``) hold the package to it.
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
    # the eager plane's engine knobs (reference env_registry.py:142-148,
    # :164-169, :251-286)
    "HOROVOD_CACHE_CAPACITY": (
        1024, "eager ops: response-cache capacity in entries (0 disables)"),
    "HOROVOD_STALL_CHECK_TIME_SECONDS": (
        60.0, "eager ops: stall-inspector warning threshold"),
    "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": (
        0.0, "eager ops: stall-inspector abort deadline (0 = never abort)"),
    "HOROVOD_STALL_CHECK_DISABLE": (
        False, "eager ops: disable the stall-inspector scan"),
    "HOROVOD_SERVING_MODE": (
        False, "eager ops: sub-threshold tensors skip the fusion buffer "
               "(express lane, launched ahead of bulk traffic)"),
    "HOROVOD_LOW_LATENCY_THRESHOLD": (
        4096, "payload bytes at or below which an eager op rides the "
              "express lane instead of the fusion buffer"),
    "HOROVOD_TUNE": (
        False, "exposed-comm-driven frontend autotuner; keeps the eager "
               "plane's tuned-parameter push open at world > 1"),
    "HOROVOD_TUNE_EPOCH_STEPS": (
        16, "train steps per tuning epoch (one configuration measured per "
            "epoch)"),
    "HOROVOD_TUNE_SAMPLES": (
        24, "tuning-epoch budget before the tuner fixes the best "
            "configuration"),
    "HOROVOD_TUNE_WARMUP_EPOCHS": (
        1, "measurement epochs discarded before the search starts"),
    "HOROVOD_TUNE_ACCURACY_TOLERANCE": (
        0.02, "max relative probe-loss degradation an int8 compression "
              "choice may cause before the tuner rolls it back and bans "
              "it"),
    "HOROVOD_TUNE_LOG": (
        None, "CSV file recording frontend-tuner samples (objective + "
              "config per row)"),
    "HOROVOD_AUTOTUNE": (
        False, "online Bayesian tuning of the eager plane's cycle time, "
               "fusion threshold and cache"),
    "HOROVOD_AUTOTUNE_LOG": (None, "CSV file recording autotune samples"),
    "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": (
        3, "autotune samples discarded before scoring begins"),
    "HOROVOD_AUTOTUNE_STEPS": (
        30, "autotune samples scored before the parameters freeze"),
    "HOROVOD_AUTOTUNE_SAMPLE_CYCLES": (
        10, "negotiation rounds with traffic aggregated per autotune "
            "sample"),
    "HOROVOD_TIMELINE": (
        None, "Chrome-trace timeline path of the eager ops (rank 0 "
              "writes)"),
    "HOROVOD_TIMELINE_MARK_CYCLES": (
        False, "add negotiation-round markers to the timeline"),
    "HOROVOD_HOSTNAME": ("localhost", "this worker's hostname as the "
                                      "launcher addresses it"),
    "HOROVOD_CONTROLLER_ADDR": (
        "127.0.0.1", "host of rank 0: the TCPStore endpoint of the job's "
                     "process groups (set by the launcher)"),
    "HOROVOD_CONTROLLER_PORT": (0, "TCPStore port of the job's process "
                                   "groups (set by the launcher)"),
    "HOROVOD_CONTROLLER_DATA_PORT": (
        0, "second port the launcher reserves beside the controller port "
           "(the reference engine's eager data channel; the port's "
           "workers read none of it, the launcher and cluster_job set it "
           "so the reference's launch contract holds)"),
    "HOROVOD_CLUSTER_JOB": (
        None, "cluster-scheduler job id scoping the controller endpoint "
              "negotiation in the KV (runner/cluster_job.py)"),
    "HOROVOD_CLUSTER_ROUND": (
        "0", "per-run scope of the controller endpoint negotiation "
             "(actor pools of the Ray executors)"),
    "HOROVOD_SMALL_TENSOR_ALGO": (
        "star", "the reference engine's small-allreduce route (star | "
                "rd); the launcher refuses --small-tensor-algo, which would "
                "set it, since NCCL picks its own route"),
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
    # the launcher, the elastic driver and its supervisor, the metrics
    # plane and the autoscaler (reference env_registry.py)
    "HOROVOD_LOG_LEVEL": (
        "warning", "trace/debug/info/warning/error/fatal — the Python "
                   "layers"),
    "HOROVOD_LOG_TIMESTAMP": (
        False, "prefix timestamps on log lines"),
    "HOROVOD_JOB_NAME": (
        "default", "job label on every metrics sample"),
    "HOROVOD_KV_DIR": (
        None, "durable rendezvous KV: WAL + snapshot directory (unset = in-"
              "memory only; set = crash-recoverable control plane + epoch "
              "fencing)"),
    "HOROVOD_KV_SNAPSHOT_BYTES": (
        1048576, "WAL size that triggers a compacted snapshot (write-then-"
                 "rename)"),
    "HOROVOD_KV_REPLICAS": (
        0, "run the durable KV as this many leader-lease replicas (<2 = "
           "the single embedded KV; >=2 = supervisor-spawned replica "
           "subprocesses with majority-acked replication and split-"
           "brain-proof failover)"),
    "HOROVOD_KV_LEASE_SECONDS": (
        2.0, "KV replica leader lease; followers elect after 1.5 leases "
             "of leader silence, so failover takes about this long"),
    "HOROVOD_DRIVER_SUPERVISE": (
        True, "run the elastic driver under the launcher's supervisor "
              "(respawn on crash); only engages when HOROVOD_KV_DIR is set"),
    "HOROVOD_DRIVER_RESTART_LIMIT": (
        10, "driver crash respawns before the supervisor gives up"),
    "HOROVOD_DRIVER_RESTART_BACKOFF_SECONDS": (
        0.5, "pause between a driver crash and its respawn"),
    "HOROVOD_DRIVER_RECOVERY_WAIT_SECONDS": (
        5.0, "how long a recovered driver waits for live-worker heartbeats"
             " before treating missing slots as dead (interrupted-resize "
             "resume)"),
    "HOROVOD_DRIVER_METRICS_PORT": (
        None, "driver-side /metrics endpoint serving straggler gauges (0 = "
              "ephemeral; unset = off)"),
    "HOROVOD_WORKER_HEARTBEAT_TIMEOUT_SECONDS": (
        10.0, "heartbeat age past which an adopted (pid-unreachable) worker"
              " is declared dead by the recovered driver"),
    "HOROVOD_FAILURES_TO_BLACKLIST": (
        3, "worker failures on a host before blacklisting"),
    "HOROVOD_BLACKLIST_COOLDOWN_SECONDS": (
        300.0, "blacklisted hosts become eligible again after this long (<=0"
               " = permanent)"),
    "HOROVOD_METRICS_PORT": (
        None, "base port of the per-worker Prometheus endpoint (actual = "
              "base + local_rank; unset = off; 0 = ephemeral)"),
    "HOROVOD_METRICS_AGG": (
        True, "per-host telemetry aggregation: local_rank 0's exporter "
              "scrapes co-located ranks and serves /agg.json so the driver "
              "and hvd-top scale O(hosts), not O(ranks) (0 = per-rank "
              "scrapes only)"),
    "HOROVOD_AGG_INTERVAL_SECONDS": (
        1.0, "refresh cadence of the per-host aggregator's co-located "
             "scrape"),
    "HOROVOD_AGG_STALE_SECONDS": (
        10.0, "max /agg.json age before the driver falls back to direct "
              "per-rank scrape for that host (also the hvd-top STALE marker"
              " bound)"),
    "HOROVOD_FLIGHT_RECORDER_SIZE": (
        2048, "per-collective event ring capacity (0 disables recording)"),
    "HOROVOD_FLIGHT_DIR": (
        None, "directory for per-rank flight dumps (flight_rank<R>.json); "
              "unset = no automatic dumps"),
    "HOROVOD_STEP_ATTRIBUTION": (
        True, "per-step time attribution + anomaly detection fed by the "
              "frontend step timer (0 disables the attributor and the step "
              "marks)"),
    "HOROVOD_ANOMALY_STDDEVS": (
        4.0, "step-time spike threshold in rolling sigmas before an anomaly "
             "event fires (structured log + automatic flight dump)"),
    "HOROVOD_ANOMALY_WINDOW": (
        64, "rolling window of recent step times behind anomaly detection"),
    "HOROVOD_ATTRIBUTION_EVERY": (
        10, "steps between flight-ring attribution refreshes (per-step "
            "decomposition gauge export cadence; 0 = frontend timing only)"),
    "HOROVOD_TOP_INTERVAL": (
        2.0, "hvd-top live-view refresh interval in seconds"),
    "HOROVOD_TOP_ROLLUP_RANKS": (
        64, "fleet size above which hvd-top defaults to host-rollup rows "
            "(per-host p99/EXP%/STALL% aggregates; --rank <r> drills down, "
            "--no-rollup forces per-rank rows)"),
    "HOROVOD_SOAK_ARTIFACT_DIR": (
        None, "chaos-soak artifact directory (KV WAL + flight dumps + "
              "journal) that hvd-doctor reads when no directory is given"),
    "HOROVOD_STRAGGLER_STDDEVS": (
        3.0, "leave-one-out skew threshold k for straggler flagging"),
    "HOROVOD_STRAGGLER_WINDOWS": (
        3, "consecutive skewed windows before a rank is flagged"),
    "HOROVOD_AUTOSCALE": (
        False, "driver-side autoscaler: watch serving SLOs scraped from "
               "worker /metrics.json and grow/shrink the fleet (scale-up on "
               "sustained queue depth / p99 breach, scale-down by draining "
               "idle workers)"),
    "HOROVOD_AUTOSCALE_MIN_WORKERS": (
        1, "fleet floor: scale-down never drains below this many workers"),
    "HOROVOD_AUTOSCALE_MAX_WORKERS": (
        8, "fleet ceiling: scale-up never targets more than this many "
           "workers"),
    "HOROVOD_AUTOSCALE_QUEUE_BOUND": (
        8, "per-worker admission queue depth above which a window counts"
           " as breached (scale-up pressure)"),
    "HOROVOD_AUTOSCALE_P99_MS_BOUND": (
        500.0, "request p99 latency SLO in ms; a window past it counts as "
               "breached"),
    "HOROVOD_AUTOSCALE_IDLE_OCCUPANCY": (
        0.25, "fleet mean in-flight requests per worker at or below which "
              "(with every queue empty) a window counts as idle (scale-down"
              " pressure)"),
    "HOROVOD_AUTOSCALE_UP_WINDOWS": (
        2, "consecutive breached observation windows before a scale-up "
           "(hysteresis — a one-window spike never resizes the fleet)"),
    "HOROVOD_AUTOSCALE_DOWN_WINDOWS": (
        2, "consecutive idle observation windows before a scale-down "
           "drain"),
    "HOROVOD_AUTOSCALE_UP_COOLDOWN_SECONDS": (
        5.0, "minimum seconds between scale-up decisions"),
    "HOROVOD_AUTOSCALE_DOWN_COOLDOWN_SECONDS": (
        15.0, "minimum seconds between scale-down decisions (longer than "
              "up: shedding capacity is the riskier direction)"),
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


def env_raw(name: str):
    """The unparsed value of registered variable ``name`` (None when
    unset)."""
    return _raw(name)


def env_is_set(name: str) -> bool:
    """True when registered variable ``name`` is set and non-empty."""
    return _raw(name) not in (None, "")


def render_env_table() -> str:
    """The markdown table README.md's port section embeds between the
    ``<!-- torch-env-table:begin -->`` / ``<!-- torch-env-table:end -->``
    markers (counterpart of the reference's ``render_env_table``, over
    this registry's columns). Regenerate with ``python -m
    horovod_tpu_torch.lint --write-env-table``; lint rule HVL006 fails
    when the embedded copy drifts."""
    lines = ["| Variable | Default | Description |", "|---|---|---|"]
    for name in sorted(REGISTRY):
        default, doc = REGISTRY[name]
        if default is None:
            shown = "_(unset)_"
        elif isinstance(default, bool):
            shown = "1" if default else "0"
        else:
            shown = f"`{default}`"
        lines.append(f"| `{name}` | {shown} | {doc} |")
    return "\n".join(lines) + "\n"
