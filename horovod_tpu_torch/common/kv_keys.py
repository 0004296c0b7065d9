"""Typed registry of every rendezvous-KV key family.

Counterpart of ``horovod_tpu/common/kv_keys.py``: every family of the
reference is declared once with its pattern, its writer role, whether
driver-originated writes of it claim the control epoch, and the WAL shard
its mutations land in (all of them, so the WAL routes each key as the
reference does), with a builder for each family the port writes. The
typed builders are the only way the port builds a key; :func:`match`
classifies a concrete key; :func:`shard_for_key` /
:func:`shard_for_prefix` route the durable KV's appends
(``runner/http_kv.py``). The strings, the families and their shards must
stay the reference's: the two sides of every protocol meet on them, and a
WAL written by either package's server replays on the other's.

Writer roles: ``driver`` writes claim the control epoch (the KV fences
strictly-older claimants); ``worker`` / ``serve-worker`` / ``tuner`` /
``task`` writes are deliberately epoch-less. Unregistered keys route to
the ``core`` shard: routing never refuses a write the server would accept.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Tuple

_VAR_RE = re.compile(r"<([a-z_]+)>")


@lru_cache(maxsize=None)
def _compiled(pattern: str) -> re.Pattern:
    """One compiled matcher per family pattern — conformance replay
    calls match() per WAL op, so the build must not repeat."""
    parts = []
    pos = 0
    for m in _VAR_RE.finditer(pattern):
        parts.append(re.escape(pattern[pos:m.start()]))
        parts.append(f"(?P<{m.group(1)}>[^/]+)")
        pos = m.end()
    parts.append(re.escape(pattern[pos:]))
    return re.compile("^" + "".join(parts) + "$")


@dataclass(frozen=True)
class KVKeyFamily:
    name: str           # family id, e.g. "drain"
    pattern: str        # doc pattern, e.g. "drain/<host>/<slot>"
    writer: str         # "driver" | "worker" | "serve-worker" | "tuner" | "task"
    epoch_claimed: bool  # driver-originated: writes must claim the epoch
    doc: str
    shard: str = "core"  # WAL shard this family's mutations land in

    @property
    def prefix(self) -> str:
        """Literal text up to the first variable segment (what HVL007
        scans for; '' only for exact singleton keys)."""
        m = _VAR_RE.search(self.pattern)
        return self.pattern if m is None else self.pattern[:m.start()]

    @property
    def exact(self) -> bool:
        """True for singleton keys (the pattern has no variables)."""
        return _VAR_RE.search(self.pattern) is None

    @property
    def regex(self) -> re.Pattern:
        return _compiled(self.pattern)


FAMILIES: Dict[str, KVKeyFamily] = {}

# every declared shard; "core" is both the default and the legacy
# (pre-sharding) WAL, so old kv_dirs replay unchanged
SHARDS = ("core", "heartbeat", "serve", "tune", "autoscale")


def _decl(name: str, pattern: str, writer: str, epoch_claimed: bool,
          doc: str, shard: str = "core"):
    assert name not in FAMILIES, name
    assert shard in SHARDS, (name, shard)
    FAMILIES[name] = KVKeyFamily(name, pattern, writer, epoch_claimed,
                                 doc, shard)


# -- elastic rendezvous (driver-published, epoch-claimed) -------------------
_decl("generation", "generation", "driver", True,
      "the driver's current topology generation")
_decl("control_epoch", "control_epoch", "driver", True,
      "the acting driver's control epoch (worker fencing floor)")
_decl("notify", "notify", "driver", True,
      "push notification that a newer generation exists")
_decl("go", "go/g<gen>", "driver", True,
      "go-barrier release for one generation (all slots READY)")
_decl("rank_and_size", "rank_and_size/g<gen>/<host>/<local_rank>", "driver",
      True, "per-slot topology record for one generation")
_decl("metrics_targets", "metrics_targets", "driver", True,
      "aggregated worker /metrics endpoints (hvd-top discovery)",
      shard="heartbeat")
_decl("agg_targets", "agg_targets", "driver", True,
      "live per-host aggregator /agg.json endpoints (the tiered-scrape "
      "discovery table: hvd-top host rollups and O(hosts) heartbeats)",
      shard="heartbeat")
_decl("serve_targets", "serve_targets", "driver", True,
      "aggregated serving endpoints (router discovery)", shard="serve")
_decl("straggler", "straggler/g<gen>/<rank>", "driver", True,
      "driver-relayed straggler event for one rank")
_decl("anomaly", "anomaly/g<gen>/<rank>", "driver", True,
      "driver-relayed step-time anomaly event for one rank")

# -- worker-originated records (deliberately epoch-less) --------------------
_decl("worker_state", "worker_state/g<gen>/<host>/<local_rank>", "worker",
      False, "READY/SUCCESS/FAILURE/DRAINED registry record")
_decl("worker_heartbeat", "worker_heartbeat/<host>/<slot>", "worker", False,
      "worker liveness heartbeat (driver-recovery adoption)",
      shard="heartbeat")
_decl("drain", "drain/<host>/<slot>", "worker", False,
      "preemption-notice drain announcement")
_decl("shard_handoff", "shard_handoff/w<world>/<old_rank>", "worker", False,
      "departing rank's live ZeRO shard payload (world-scoped)")
_decl("reset_request", "reset_request/g<gen>", "worker", False,
      "worker request for a fresh rendezvous round past a dead generation")
_decl("metrics_addr", "metrics_addr/<host>/<local_rank>", "worker", False,
      "worker /metrics endpoint publication (driver aggregates)",
      shard="heartbeat")
_decl("agg_addr", "agg_addr/<host>", "worker", False,
      "per-host aggregator /agg.json endpoint (published by local_rank "
      "0's exporter; the driver prefers it over per-rank scrapes)",
      shard="heartbeat")

# -- serving plane ----------------------------------------------------------
_decl("serve_addr", "serve_addr/<host>/<local_rank>", "serve-worker", False,
      "serving worker endpoint publication (driver aggregates)",
      shard="serve")
_decl("serve_stop", "serve_stop", "serve-worker", False,
      "cooperative stop signal polled by serving workers", shard="serve")

# -- traffic-driven autoscaler (driver-published, epoch-claimed) ------------
_decl("autoscale_decision", "autoscale/decision", "driver", True,
      "the autoscaler's current decision record (decide→drain→resize→ack "
      "state machine; a recovered driver resumes it instead of re-deciding)",
      shard="autoscale")
_decl("autoscale_event", "autoscale/event/<seq>", "driver", True,
      "per-decision audit record (action, reason, victim, outcome)",
      shard="autoscale")

# -- autotuner parameter sync ----------------------------------------------
_decl("tune_config", "tune_config/<job>", "tuner", False,
      "converged tuner config for a job (follower adoption)", shard="tune")
_decl("tune_epoch", "tune_epoch/<job>/<epoch>", "tuner", False,
      "per-epoch tuner config broadcast (cycle-fenced adoption)",
      shard="tune")

# -- task execution (runner.run_task / cluster jobs) ------------------------
_decl("task_fn", "task_fn", "task", False,
      "pickled task function for shared-nothing run_task workers")
_decl("task_started", "task_started/<rank>", "task", False,
      "per-rank task-start acknowledgement")
_decl("task_result", "task_result/g<gen>/<rank>", "task", False,
      "per-rank pickled task result for one generation")
_decl("cluster_controller", "cluster/<job>/r<round>/controller", "task",
      False, "dynamically negotiated controller endpoint for a cluster job")
_decl("subset_ports", "subset_ports/<members>/r<round>", "task", False,
      "leader-allocated ports for a process-subset communicator")
_decl("soak_event", "soak/ev<n>", "task", False,
      "chaos-soak event marker (tests/chaos.py control-plane sidecar)")


# -- typed builders ---------------------------------------------------------
# One function per family; prefix helpers mirror the driver's GC scans.

def generation() -> str:
    return "generation"


def control_epoch() -> str:
    return "control_epoch"


def notify() -> str:
    return "notify"


def go(gen: int) -> str:
    return f"go/g{int(gen)}"


def rank_and_size(gen: int, host, local_rank) -> str:
    return f"rank_and_size/g{int(gen)}/{host}/{local_rank}"


def rank_and_size_prefix(gen: int) -> str:
    # trailing "/" so g1 can't swallow g10's keys
    return f"rank_and_size/g{int(gen)}/"


def worker_state(gen: int, host, local_rank) -> str:
    return f"worker_state/g{int(gen)}/{host}/{local_rank}"


def worker_state_prefix(gen: int) -> str:
    return f"worker_state/g{int(gen)}/"


def worker_heartbeat(host, slot) -> str:
    return f"worker_heartbeat/{host}/{slot}"


def drain(host, slot) -> str:
    return f"drain/{host}/{slot}"


def shard_handoff(world: int, old_rank: int) -> str:
    return f"shard_handoff/w{int(world)}/{int(old_rank)}"


def reset_request(gen: int) -> str:
    return f"reset_request/g{int(gen)}"


def straggler(gen: int, rank) -> str:
    return f"straggler/g{int(gen)}/{rank}"


def straggler_prefix(gen: int) -> str:
    return f"straggler/g{int(gen)}/"


def anomaly(gen: int, rank) -> str:
    return f"anomaly/g{int(gen)}/{rank}"


def anomaly_prefix(gen: int) -> str:
    return f"anomaly/g{int(gen)}/"


def metrics_targets() -> str:
    return "metrics_targets"


def serve_targets() -> str:
    return "serve_targets"


def serve_addr(host, local_rank) -> str:
    return f"serve_addr/{host}/{local_rank}"


def serve_stop() -> str:
    return "serve_stop"


def metrics_addr(host, local_rank) -> str:
    return f"metrics_addr/{host}/{local_rank}"


def agg_addr(host) -> str:
    return f"agg_addr/{host}"


def agg_targets() -> str:
    return "agg_targets"


def autoscale_decision() -> str:
    return "autoscale/decision"


def autoscale_event(seq: int) -> str:
    return f"autoscale/event/{int(seq)}"


def tune_config(job: str) -> str:
    return f"tune_config/{job}"


def tune_epoch(job: str, epoch: int) -> str:
    return f"tune_epoch/{job}/{int(epoch)}"


def task_fn() -> str:
    return "task_fn"


def task_started(rank) -> str:
    return f"task_started/{rank}"


def task_result(gen: int, rank) -> str:
    return f"task_result/g{int(gen)}/{rank}"


def cluster_controller(job: str, round) -> str:
    return f"cluster/{job}/r{round}/controller"


def subset_ports(members, round) -> str:
    return ("subset_ports/" + "-".join(str(m) for m in members) +
            f"/r{round}")


def soak_event(n: int) -> str:
    return f"soak/ev{int(n)}"


# -- classification ---------------------------------------------------------

def match(key: str) -> Optional[Tuple[str, Dict[str, str]]]:
    """Classify a concrete key: ``(family_name, captured_args)`` or None
    when no registered family matches (a conformance divergence)."""
    for fam in FAMILIES.values():
        m = fam.regex.match(key)
        if m is not None:
            return fam.name, m.groupdict()
    return None


def match_prefix(prefix: str) -> Optional[str]:
    """Classify a delete_prefix scan: the family whose keys live under
    ``prefix``, or None. A GC prefix is valid when some family pattern
    starts with it (e.g. ``rank_and_size/g3/``)."""
    for fam in FAMILIES.values():
        if fam.exact:
            continue
        # a concrete prefix like "worker_state/g3/" matches the family
        # when the family regex accepts some extension of it
        if prefix.startswith(fam.prefix):
            return fam.name
    return None


def slash_prefixes() -> Dict[str, str]:
    """{literal prefix -> family} for every non-singleton family — the
    HVL007 scan list (singletons are matched at KV-accessor call sites
    instead, since bare words like 'generation' appear in ordinary
    strings)."""
    return {fam.prefix: fam.name for fam in FAMILIES.values()
            if not fam.exact}


def singleton_names() -> Dict[str, str]:
    """{exact key -> family} for singleton families."""
    return {fam.pattern: fam.name for fam in FAMILIES.values() if fam.exact}


# -- WAL shard routing -------------------------------------------------------

def shard_of(family: str) -> str:
    """The WAL shard a registered family's mutations land in."""
    return FAMILIES[family].shard


def shard_for_key(key: str) -> str:
    """Route a concrete key to its WAL shard. Unregistered keys route to
    ``core`` — routing never refuses a write the server would accept."""
    m = match(key)
    return FAMILIES[m[0]].shard if m is not None else "core"


def shard_for_prefix(prefix: str) -> str:
    """Route a delete_prefix scan to the shard its family lives in (a GC
    prefix never spans shards: each family maps to exactly one)."""
    fam = match_prefix(prefix)
    return FAMILIES[fam].shard if fam is not None else "core"

