"""Executable protocol specs for the port's control plane.

Counterpart of ``horovod_tpu/verify/specs.py``: the same nine explicit
state machines and 24 seeded mutants, built over the port's own constants
and rules (the ``SPECS`` registry at the bottom is the authoritative list
— ``python -m horovod_tpu_torch.verify`` enumerates it):

- :class:`CycleSpec` — the eager plane's negotiation round + fast abort
  (the round's exchange failing on every rank, ``_fail_all``) + the
  express-lane partition (cross-rank exec-order agreement);
- :class:`EpochSpec` — control-epoch fencing: KV 409/adopt rules, the
  worker floor, driver recovery with heartbeat adoption;
- :class:`DrainSpec` — preemption drain → shard handoff → resize, with
  the driver's scan-before-refresh heartbeat ordering and the reap-time
  last-chance drain check;
- :class:`TuneSpec` — rank 0's ``TunedParams`` push, adopted by every
  rank at the end of one negotiation round;
- :class:`AutoscaleSpec` — the SLO→fleet-size decision loop;
- :class:`PagedCacheSpec` — serving block-paged KV-cache accounting;
- :class:`ScrapeSpec` — the tiered telemetry scrape plane;
- :class:`ReplicaSpec` — leader-lease KV replication: majority-ack
  commit, epoch-as-term elections, self-fencing, divergence repair;
- :class:`JournalSpec` — the durable event journal: flush-then-ack,
  segment rotation, closed-segment retention, crash-loss accounting.

Spec constants come from the port's code: the express threshold and the
autoscaler and paged-cache defaults from ``common/env.py``'s REGISTRY
(``engine_constants``), KV keys in trace labels from ``common/kv_keys.py``,
and the epoch, election and express rules are the shared functions in
``verify/rules.py`` that tests assert against the port's ``KVServer``,
``observe_epoch`` and replicated KV. Where the port's mechanism differs
from the reference engine's (the cycle's abort, the tune spec's
environment hazard), the spec models the port's (ROADMAP C26).

Seeded historical bugs are re-introducible as **mutations** (the
``MUTANTS`` registry): ``hvd-check --mutant <name>`` must produce a
counterexample for each, which is what proves the invariants have teeth.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

from horovod_tpu_torch.common import kv_keys
from horovod_tpu_torch.common.env import REGISTRY
from horovod_tpu_torch.verify import engine_constants, rules
from horovod_tpu_torch.verify.spec import Invariant, Spec


def _rep(t: tuple, i: int, v) -> tuple:
    return t[:i] + (v,) + t[i + 1:]


# ===========================================================================
# Negotiation round + fast abort + express-lane partition
# ===========================================================================

class CycleState(NamedTuple):
    pending: tuple        # per rank: frozenset of negotiating tensor names
    next_idx: tuple       # per rank: position in the submit script
    exec_log: tuple       # per rank: tuple of executed tensor names
    abort_req: tuple      # per rank: aborted its process groups
    aborted: tuple        # per rank: session dead
    crashed: tuple        # per rank: process dead (fault)
    missed_abort: bool    # a cycle completed without honoring a signal
    crashes_left: int
    aborts_left: int


class CycleSpec(Spec):
    """Two ranks of the eager plane (``common/eager.py``) submit the same
    tensor program (a sub-threshold gradient and a bulk gradient) at
    independent speeds; each negotiation round (one ``all_gather_object``
    on the control group) finds the common set, peels the express lane,
    and launches. Faults: one rank crash, one rank aborting its process
    groups (``shutdown()`` of a broken generation), after which it submits
    nothing more.

    The reference engine ORs an abort bit into the coordination word. The
    port has no flag word: a dead or aborted peer makes the round's
    exchange raise on every surviving rank, whose ``except`` fails every
    waiting handle through ``_fail_all`` (``HorovodInternalError`` at
    ``synchronize``) and ends the negotiation thread. The
    ``ignore_abort`` mutation is that handler swallowing the error and
    negotiating on — the hazard lint rule HVL003 looks for."""

    # (name, size_bytes): one tensor under the express threshold, one
    # over. Named so the express-first order differs from plain sorted
    # order — a divergent partition must actually reorder execution.
    SUBMITS = (("tiny_update", 1024), ("dense_grad", 1 << 20))

    def __init__(self, ranks: int = 2, rank_divergent_express: bool = False,
                 ignore_abort: bool = False, crashes: int = 1,
                 aborts: int = 1):
        super().__init__(name="cycle", mutations=tuple(
            m for m, on in [("rank_divergent_express",
                             rank_divergent_express),
                            ("ignore_abort", ignore_abort)] if on))
        self.ranks = ranks
        self.rank_divergent_express = rank_divergent_express
        self.ignore_abort = ignore_abort
        self.crashes = crashes
        self.aborts = aborts
        self.threshold = engine_constants.low_latency_threshold_default()

    def initial(self) -> CycleState:
        n = self.ranks
        return CycleState(
            pending=(frozenset(),) * n, next_idx=(0,) * n,
            exec_log=((),) * n, abort_req=(False,) * n,
            aborted=(False,) * n, crashed=(False,) * n,
            missed_abort=False, crashes_left=self.crashes,
            aborts_left=self.aborts)

    def _alive(self, s: CycleState) -> List[int]:
        return [r for r in range(self.ranks)
                if not s.crashed[r] and not s.aborted[r]]

    def _partition(self, rank: int, common: frozenset) \
            -> Tuple[tuple, tuple]:
        """(express, bulk) exec order for one rank — identical on every
        rank in ``EagerExecutor._batches``; the mutation gives rank >= 1 a
        divergent threshold (the historical hazard class: rank-dependent
        fusion/express eligibility)."""
        threshold = self.threshold
        if self.rank_divergent_express and rank >= 1:
            threshold = 0
        sizes = dict(self.SUBMITS)
        express = tuple(sorted(
            t for t in common
            if rules.express_eligible(sizes[t], threshold)))
        bulk = tuple(sorted(t for t in common if t not in express))
        return express, bulk

    def actions(self, s: CycleState):
        out = []
        alive = self._alive(s)
        for r in alive:
            # a rank that aborted its groups has stopped its executor
            if s.next_idx[r] < len(self.SUBMITS) and not s.abort_req[r]:
                name = self.SUBMITS[s.next_idx[r]][0]
                out.append((
                    f"rank{r}.enqueue({name})",
                    s._replace(
                        pending=_rep(s.pending, r,
                                     s.pending[r] | {name}),
                        next_idx=_rep(s.next_idx, r, s.next_idx[r] + 1))))
        for r in alive:
            if s.crashes_left > 0:
                out.append((f"fault: rank{r} crashes",
                            s._replace(crashed=_rep(s.crashed, r, True),
                                       crashes_left=s.crashes_left - 1)))
            if s.aborts_left > 0 and not s.abort_req[r]:
                out.append((
                    f"rank{r}.shutdown() aborts its process groups",
                    s._replace(abort_req=_rep(s.abort_req, r, True),
                               aborts_left=s.aborts_left - 1)))
        if alive:
            out.append(self._cycle(s, alive))
        return out

    def _cycle(self, s: CycleState, alive: List[int]):
        abort_signal = any(s.crashed) or any(s.abort_req[r] for r in alive)
        if abort_signal and not self.ignore_abort:
            # fast abort: the round's all_gather_object raises on EVERY
            # surviving rank, and each fails its waiters in this round
            aborted = s.aborted
            for r in alive:
                aborted = _rep(aborted, r, True)
            return ("round: the exchange raises -> _fail_all on "
                    "every alive rank",
                    s._replace(aborted=aborted))
        if abort_signal:
            # MUTATION ignore_abort: the round's except swallows the
            # backend error and negotiates on — the missed signal is the
            # violation
            s = s._replace(missed_abort=True)
        common = frozenset.intersection(
            *[s.pending[r] for r in range(self.ranks)]) \
            if self.ranks else frozenset()
        pending = s.pending
        exec_log = s.exec_log
        for r in range(self.ranks):
            pending = _rep(pending, r, s.pending[r] - common)
            express, bulk = self._partition(r, common)
            exec_log = _rep(exec_log, r, s.exec_log[r] + express + bulk)
        label = "round: negotiate " + (
            f"{sorted(common)}" if common else "(nothing common)")
        return label, s._replace(pending=pending, exec_log=exec_log)

    @property
    def invariants(self) -> List[Invariant]:
        def exec_agreement(s: CycleState) -> bool:
            logs = list(s.exec_log)
            for i in range(len(logs)):
                for j in range(i + 1, len(logs)):
                    a, b = logs[i], logs[j]
                    n = min(len(a), len(b))
                    if a[:n] != b[:n]:
                        return False
            return True

        def abort_honored(s: CycleState) -> bool:
            return not s.missed_abort

        return [
            Invariant(
                "exec_order_agreement",
                "every pair of ranks executes negotiated collectives in "
                "the same order (express-lane partition included) — "
                "divergence deadlocks the data plane", exec_agreement),
            Invariant(
                "abort_within_one_cycle",
                "a pending crash/abort signal is honored by the very "
                "next negotiation round on every surviving rank",
                abort_honored),
        ]


# ===========================================================================
# Control-epoch fencing (split-brain protection, adoption)
# ===========================================================================

class DriverS(NamedTuple):
    alive: bool
    fenced: bool        # observed a 409; stood down
    epoch: int
    gen: int            # last generation this driver published
    last_notify: Optional[tuple]  # (gen, epoch) at this driver's replica
    recovered: bool     # ran its adoption pass (recovered drivers only)
    writes_left: int


class EpochState(NamedTuple):
    kv_epoch: int         # authoritative (durable) server epoch
    persist_epoch: int    # what the epoch file holds
    last_write_epoch: int  # epoch of the last ACCEPTED mutation
    write_regressed: bool  # an older-epoch write landed after a newer one
    kv_notify: Optional[tuple]  # (gen, epoch) in the durable store
    drivers: tuple        # DriverS per driver slot (0 = original, 1 = respawn)
    worker_alive: bool
    worker_procs: int     # live processes for the one modeled slot
    worker_floor: int
    worker_gen: int
    worker_max_gen: int   # highest generation ever accepted
    respawns_left: int
    partitions_left: int
    kills_left: int
    partitioned: tuple    # per driver: supervisor presumes it dead


class EpochSpec(Spec):
    """One durable KV, one worker slot, an original driver and one
    supervisor respawn. Faults: a driver partition (presumed dead but
    still writing), a worker kill. The lingering driver's own KV replica
    is modeled per-driver (``last_notify``) — the window the worker-side
    epoch floor exists for."""

    def __init__(self, accept_stale_notify: bool = False,
                 no_fence: bool = False, no_adoption_check: bool = False):
        super().__init__(name="epoch", mutations=tuple(
            m for m, on in [("accept_stale_notify", accept_stale_notify),
                            ("no_fence", no_fence),
                            ("no_adoption_check", no_adoption_check)]
            if on))
        self.accept_stale_notify = accept_stale_notify
        self.no_fence = no_fence
        self.no_adoption_check = no_adoption_check

    def initial(self) -> EpochState:
        d0 = DriverS(alive=True, fenced=False, epoch=1, gen=0,
                     last_notify=None, recovered=False, writes_left=2)
        d1 = DriverS(alive=False, fenced=False, epoch=0, gen=0,
                     last_notify=None, recovered=False, writes_left=2)
        return EpochState(
            kv_epoch=1, persist_epoch=1, last_write_epoch=1,
            write_regressed=False, kv_notify=None, drivers=(d0, d1),
            worker_alive=True, worker_procs=1, worker_floor=1,
            worker_gen=0, worker_max_gen=0,
            respawns_left=1, partitions_left=1, kills_left=1,
            partitioned=(False, False))

    def actions(self, s: EpochState):
        out = []
        # fault: partition the original driver (supervisor thinks it
        # crashed; the process lingers and keeps trying to act)
        for i, d in enumerate(s.drivers):
            if d.alive and not s.partitioned[i] and s.partitions_left > 0:
                out.append((
                    f"fault: driver{i} partitioned (supervisor presumes "
                    f"it dead; process lingers)",
                    s._replace(partitioned=_rep(s.partitioned, i, True),
                               partitions_left=s.partitions_left - 1)))
        # supervisor respawn: a fresh driver over the same KV dir; the
        # durable replay bumps the persistent epoch (KVServer contract)
        if s.respawns_left > 0 and not s.drivers[1].alive and \
                any(s.partitioned[i] for i in range(2)):
            new_epoch = s.persist_epoch + 1
            rec_gen = s.kv_notify[0] if s.kv_notify else 0
            d1 = DriverS(alive=True, fenced=False, epoch=new_epoch,
                         gen=rec_gen, last_notify=None, recovered=False,
                         writes_left=2)
            out.append((
                f"supervisor respawns driver1 (control epoch "
                f"{s.persist_epoch} -> {new_epoch})",
                s._replace(drivers=_rep(s.drivers, 1, d1),
                           kv_epoch=new_epoch, persist_epoch=new_epoch,
                           respawns_left=s.respawns_left - 1)))
        # recovered driver's adoption pass: adopt a live (heartbeating)
        # worker, spawn only for a dead slot
        d1 = s.drivers[1]
        if d1.alive and not d1.recovered:
            if s.worker_alive and not self.no_adoption_check:
                out.append((
                    f"driver1 adopts live worker from "
                    f"{kv_keys.worker_heartbeat('host', 0)}",
                    s._replace(drivers=_rep(
                        s.drivers, 1, d1._replace(recovered=True)))))
            else:
                label = ("driver1 respawns the slot (MUTATION: skipped "
                         "the heartbeat adoption check)"
                         if s.worker_alive else
                         "driver1 spawns the dead slot")
                out.append((
                    label,
                    s._replace(
                        drivers=_rep(s.drivers, 1,
                                     d1._replace(recovered=True)),
                        worker_alive=True,
                        worker_procs=s.worker_procs + 1,
                        worker_floor=max(s.worker_floor, d1.epoch)
                        if not s.worker_alive else s.worker_floor)))
        # driver writes notify (the resize push) claiming its epoch
        for i, d in enumerate(s.drivers):
            if d.alive and not d.fenced and d.writes_left > 0:
                out.append(self._write_notify(s, i))
        # worker observes a notify — from the durable KV or from a
        # lingering driver's replica
        if s.worker_alive:
            if s.kv_notify is not None:
                act = self._observe(s, s.kv_notify, "durable KV")
                if act is not None:
                    out.append(act)
            for i, d in enumerate(s.drivers):
                if d.last_notify is not None:
                    act = self._observe(
                        s, d.last_notify, f"driver{i}'s lingering replica")
                    if act is not None:
                        out.append(act)
        # fault: kill the worker (heartbeats stop)
        if s.worker_alive and s.kills_left > 0:
            out.append((
                "fault: worker killed (heartbeats stop)",
                s._replace(worker_alive=False,
                           worker_procs=max(0, s.worker_procs - 1),
                           kills_left=s.kills_left - 1)))
        return out

    def _write_notify(self, s: EpochState, i: int):
        d = s.drivers[i]
        gen = d.gen + 1
        rec = (gen, d.epoch)
        outcome, new_epoch = rules.admit_epoch(s.kv_epoch, d.epoch)
        if outcome == rules.FENCED and not self.no_fence:
            # the 409: the stale driver stands down; its replica still
            # holds whatever it last served
            return (
                f"kv 409s driver{i}'s `{kv_keys.notify()}` write "
                f"(offered {d.epoch} < current {s.kv_epoch}); "
                f"driver{i} stands down",
                s._replace(drivers=_rep(
                    s.drivers, i,
                    d._replace(fenced=True,
                               writes_left=d.writes_left - 1))))
        regressed = s.write_regressed or d.epoch < s.last_write_epoch
        return (
            f"driver{i} writes `{kv_keys.notify()}` = (gen {gen}, "
            f"epoch {d.epoch})",
            s._replace(
                kv_epoch=new_epoch,
                persist_epoch=max(s.persist_epoch, new_epoch),
                last_write_epoch=max(s.last_write_epoch, d.epoch),
                write_regressed=regressed,
                kv_notify=rec,
                drivers=_rep(s.drivers, i, d._replace(
                    gen=gen, last_notify=rec,
                    writes_left=d.writes_left - 1))))

    def _observe(self, s: EpochState, rec: tuple, source: str):
        gen, epoch = rec
        accepted, new_floor = rules.worker_accepts(s.worker_floor, epoch)
        if not accepted and not self.accept_stale_notify:
            return None  # rejection is a no-op, not a transition
        if not accepted:
            label = (f"worker accepts STALE notify gen {gen} epoch "
                     f"{epoch} from {source} (MUTATION: floor check "
                     f"skipped)")
            new_floor = s.worker_floor
        else:
            if gen == s.worker_gen:
                return None
            label = (f"worker observes notify gen {gen} (epoch {epoch}, "
                     f"{source}); resets into it")
        return (label, s._replace(
            worker_floor=new_floor, worker_gen=gen,
            worker_max_gen=max(s.worker_max_gen, gen)))

    @property
    def invariants(self) -> List[Invariant]:
        return [
            Invariant(
                "no_split_brain",
                "once a newer-epoch driver has mutated the store, a "
                "strictly-older epoch's mutation can never land (two "
                "live drivers acting at the same time)",
                lambda s: not s.write_regressed),
            Invariant(
                "epoch_monotone_persisted",
                "the server epoch equals the persisted epoch file — an "
                "adopted newer claim is durable before it fences anyone",
                lambda s: s.kv_epoch == s.persist_epoch),
            Invariant(
                "worker_generation_monotonic",
                "a worker never resets backward into an older generation "
                "(a fenced-out driver's stale notify must not roll a "
                "worker back)",
                lambda s: s.worker_gen == s.worker_max_gen),
            Invariant(
                "no_double_spawn",
                "the one modeled slot never has two live processes "
                "(recovery must adopt heartbeating workers, not respawn "
                "them)",
                lambda s: s.worker_procs <= 1),
        ]


# ===========================================================================
# Preemption drain -> shard handoff -> resize
# ===========================================================================

class DrainState(NamedTuple):
    wphase: str            # running|announced|handed_off|exited|killed|reaped
    committed: bool        # a commit boundary passed (shard acknowledged)
    buddy: bool            # ring-buddy replica of the committed shard
    kv_drain: bool         # drain/<host>/<slot> landed
    kv_handoff: bool       # shard_handoff/w<N>/<r> landed
    kv_drained_record: bool  # DRAINED registry record written at exit
    drv_knows: bool        # driver registered the drain (host held out)
    pc: int                # heartbeat program counter (index into steps)
    drain_visible_at_hb: bool  # kv_drain at the current heartbeat's start
    placed_on_doomed: bool
    false_completion: bool
    was_killed: bool
    kills_left: int


class DrainSpec(Spec):
    """One draining worker, one driver heartbeat loop. The heartbeat is
    three atomic steps whose order IS the protocol: drain scan, then
    discovery refresh + rebalance, then reap (``runner/elastic/
    driver.py``). The historical same-heartbeat race is re-introduced by
    swapping the first two (``scan_after_refresh``);
    the reap-time last-chance drain check is removable with
    ``no_last_chance``; ``no_buddy`` drops commit-time replication."""

    def __init__(self, scan_after_refresh: bool = False,
                 no_last_chance: bool = False, no_buddy: bool = False):
        super().__init__(name="drain", mutations=tuple(
            m for m, on in [("scan_after_refresh", scan_after_refresh),
                            ("no_last_chance", no_last_chance),
                            ("no_buddy", no_buddy)] if on))
        self.no_last_chance = no_last_chance
        self.no_buddy = no_buddy
        self.steps = ["refresh", "scan"] if scan_after_refresh \
            else ["scan", "refresh"]
        self.steps.append("reap")

    def initial(self) -> DrainState:
        return DrainState(
            wphase="running", committed=False, buddy=False,
            kv_drain=False, kv_handoff=False, kv_drained_record=False,
            drv_knows=False, pc=0, drain_visible_at_hb=False,
            placed_on_doomed=False, false_completion=False,
            was_killed=False, kills_left=1)

    def actions(self, s: DrainState):
        out = []
        # -- worker side ----------------------------------------------------
        if s.wphase in ("running", "announced") and not s.committed:
            out.append((
                "worker commits a step (shard acknowledged; ring-buddy "
                "replica lands)" if not self.no_buddy else
                "worker commits a step (MUTATION: buddy replication "
                "skipped)",
                s._replace(committed=True, buddy=not self.no_buddy)))
        if s.wphase == "running":
            out.append((
                "SIGTERM: preemption notice (drain requested; KV "
                "announce goes async)",
                s._replace(wphase="announced")))
        if s.wphase in ("announced", "handed_off") and not s.kv_drain:
            # the announcement is asynchronous (a thread leaves the
            # signal context) — interleavings where it lands late, or
            # never lands before the exit, are explored for free because
            # landing is just another action the scheduler may not pick
            out.append((
                f"async `{kv_keys.drain('host', 0)}` announcement lands",
                s._replace(kv_drain=True)))
        if s.wphase == "announced" and s.committed:
            out.append((
                f"worker publishes `{kv_keys.shard_handoff(2, 1)}` at "
                "the commit boundary",
                s._replace(wphase="handed_off", kv_handoff=True)))
        if s.wphase == "handed_off":
            out.append((
                "worker records DRAINED and exits 0",
                s._replace(wphase="exited", kv_drained_record=True)))
        if s.wphase in ("running", "announced", "handed_off") and \
                s.kills_left > 0:
            out.append((
                "fault: host dies (worker killed mid-drain)",
                s._replace(wphase="killed", was_killed=True,
                           kills_left=s.kills_left - 1)))
        # -- driver heartbeat -----------------------------------------------
        step = self.steps[s.pc]
        out.append(self._hb_step(s, step))
        return out

    def _hb_step(self, s: DrainState, step: str):
        nxt = (s.pc + 1) % len(self.steps)
        ns = s._replace(pc=nxt)
        if s.pc == 0:
            # heartbeat begins: record what was already visible
            ns = ns._replace(drain_visible_at_hb=s.kv_drain)
        if step == "scan":
            if s.kv_drain:
                return ("driver heartbeat: drain scan sees "
                        f"`{kv_keys.drain('host', 0)}`; host held out",
                        ns._replace(drv_knows=True))
            return "driver heartbeat: drain scan (nothing announced)", ns
        if step == "refresh":
            includes = not s.drv_knows
            doomed = s.placed_on_doomed or (
                includes and ns.drain_visible_at_hb)
            label = ("driver heartbeat: refresh + rebalance "
                     + ("EXCLUDES the draining host"
                        if not includes else "places onto the host"))
            return label, ns._replace(placed_on_doomed=doomed)
        # reap
        if s.wphase == "exited":
            if s.drv_knows:
                return ("driver reap: known drain exited (clean "
                        "departure)", ns._replace(wphase="reaped"))
            last_chance = (s.kv_drain or s.kv_drained_record) and \
                not self.no_last_chance
            if last_chance:
                return ("driver reap: exit 0 + last-chance drain check "
                        "hits (KV key / DRAINED record) -> treated as "
                        "drain", ns._replace(wphase="reaped",
                                             drv_knows=True))
            return ("driver reap: exit 0 misread as JOB COMPLETION",
                    ns._replace(wphase="reaped", false_completion=True))
        if s.wphase == "killed":
            return ("driver reap: kill detected -> failure path "
                    "(blacklist/rebalance)", ns._replace(wphase="reaped"))
        return "driver heartbeat: reap (nothing exited)", ns

    @property
    def invariants(self) -> List[Invariant]:
        def no_shard_loss(s: DrainState) -> bool:
            if not s.committed or not s.was_killed:
                return True
            return s.kv_handoff or s.buddy

        return [
            Invariant(
                "no_false_completion",
                "a drained worker's exit 0 is never misread as job "
                "completion (the same-heartbeat race)",
                lambda s: not s.false_completion),
            Invariant(
                "no_placement_on_announced_host",
                "a rebalance never places onto a host whose drain "
                "announcement was visible before the heartbeat began "
                "(drain scan runs before discovery refresh)",
                lambda s: not s.placed_on_doomed),
            Invariant(
                "no_acknowledged_shard_loss",
                "once a commit acknowledged the shard, a kill leaves a "
                "recovery source (KV handoff or ring-buddy replica)",
                no_shard_loss),
        ]


# ===========================================================================
# Round-boundary TunedParams adoption
# ===========================================================================

class TuneState(NamedTuple):
    staged: int      # version staged on rank 0
    applied: tuple   # per rank: applied version
    thresholds: tuple  # per rank: version whose fusion/express thresholds
    #                    are in force
    pushes_left: int
    env_reads_left: int  # budget for the env-divergence mutation


# Sentinel threshold version an env read installs (distinct from any
# staged push version, like a rank-local HOROVOD_FUSION_THRESHOLD).
_ENV_THRESHOLDS = -7


class TuneSpec(Spec):
    """Rank 0's tuned-parameter push (``EagerExecutor.set_tuned_params``,
    or the autotuner's choice) must be adopted by EVERY rank at the end of
    the same negotiation round: it rides rank 0's message of the next
    round and each rank applies it in ``_apply`` -> ``_adopt``. A
    rank-divergent fusion threshold cuts different fused batches (one
    rank's single allreduce of a concatenated buffer against another's two
    of different sizes: a hang or a wrong sum on NCCL), and a divergent
    low-latency threshold peels different express sets. The
    ``apply_inline`` mutation re-introduces the hazard the staged push
    exists to prevent: applying the push immediately on rank 0. The
    ``env_divergent_thresholds`` mutation is the port's hazard of the
    reference's environment-routing class (its ``TunedParams`` carries no
    routing knobs, ROADMAP C24): a rank seeding its fusion or low-latency
    threshold from its own ``HOROVOD_FUSION_THRESHOLD`` /
    ``HOROVOD_LOW_LATENCY_THRESHOLD`` instead of adopting rank 0's push
    (ROADMAP C26)."""

    def __init__(self, ranks: int = 2, apply_inline: bool = False,
                 env_divergent_thresholds: bool = False):
        super().__init__(name="tune", mutations=tuple(
            m for m, on in [("apply_inline", apply_inline),
                            ("env_divergent_thresholds",
                             env_divergent_thresholds)] if on))
        self.ranks = ranks
        self.apply_inline = apply_inline
        self.env_divergent_thresholds = env_divergent_thresholds

    def initial(self) -> TuneState:
        return TuneState(staged=0, applied=(0,) * self.ranks,
                         thresholds=(0,) * self.ranks, pushes_left=2,
                         env_reads_left=1 if self.env_divergent_thresholds
                         else 0)

    def actions(self, s: TuneState):
        # A lost round needs no explicit fault action: "the round didn't
        # adopt" is just the scheduler never picking the round transition,
        # which the interleaving exploration already covers (a real round
        # failure fails every rank's handles — CycleSpec's territory).
        out = []
        if s.pushes_left > 0:
            v = s.staged + 1
            applied = s.applied
            label = f"rank 0 pushes TunedParams v{v} (staged)"
            if self.apply_inline:
                applied = _rep(applied, 0, v)
                label = (f"rank 0 pushes TunedParams v{v} (MUTATION: "
                         "applied inline on rank 0)")
            out.append((label, s._replace(
                staged=v, applied=applied,
                pushes_left=s.pushes_left - 1)))
        if s.env_reads_left > 0:
            for r in range(self.ranks):
                out.append((
                    f"rank {r} seeds its thresholds from its own env "
                    "(MUTATION: HOROVOD_FUSION_THRESHOLD / "
                    "HOROVOD_LOW_LATENCY_THRESHOLD read outside rank 0's "
                    "push)",
                    s._replace(
                        thresholds=_rep(s.thresholds, r, _ENV_THRESHOLDS),
                        env_reads_left=s.env_reads_left - 1)))
        out.append((
            f"round end: every rank adopts rank 0's v{s.staged} "
            f"(params + thresholds)",
            s._replace(applied=(s.staged,) * self.ranks,
                       thresholds=(s.staged,) * self.ranks)))
        return out

    @property
    def invariants(self) -> List[Invariant]:
        return [
            Invariant(
                "params_agree_between_cycles",
                "between negotiation rounds every rank runs the same "
                "applied TunedParams (rank-divergent cycle time or cache "
                "knobs desync the rounds)",
                lambda s: len(set(s.applied)) == 1),
            Invariant(
                "thresholds_agree_between_rounds",
                "between negotiation rounds every rank runs the same "
                "fusion and low-latency thresholds (a split threshold "
                "cuts different fused batches or express sets, and the "
                "ranks' collectives no longer match)",
                lambda s: len(set(s.thresholds)) == 1),
            Invariant(
                "applied_never_ahead_of_staged",
                "no rank applies a params version rank 0 has not staged",
                lambda s: all(v <= s.staged for v in s.applied)),
        ]


# ===========================================================================
# Traffic-driven autoscaler: decide -> drain -> resize -> ack
# ===========================================================================

class AutoState(NamedTuple):
    fleet: int            # accepting serving workers
    spot: str             # spot-preemption drain: none|draining|done
    auto: str             # autoscale (scale-down) drain: none|draining|done
    pressure: bool        # offered load above the SLO bound
    hot: int              # consecutive breached windows (capped)
    idle: int             # consecutive idle windows (capped)
    since: int            # windows since the last acted decision (capped)
    last_dir: int         # +1 up / -1 down / 0 none yet
    rec: Optional[tuple]  # (action, state, epoch, victim_draining) in KV
    epoch: int            # acting driver's control epoch
    kv_epoch: int         # authoritative durable epoch
    crashed: bool         # driver dead, supervisor respawn pending
    old_alive: bool       # pre-crash driver lingers with work left
    old_rec: Optional[tuple]  # the lingering driver's replica of its record
    crashes_left: int
    kills_left: int
    spikes_left: int
    recedes_left: int
    preempts_left: int
    flap: bool            # opposite decisions within one hysteresis window
    lost_acked: bool      # a second preemption notice force-killed a drain
    stale_applied: bool   # a fenced-out driver's decision mutated the fleet
    unclamped: bool       # a resize left [MIN, MAX]


class AutoscaleSpec(Spec):
    """One autoscaled serving fleet, one driver (+ a supervisor respawn),
    binary offered load. The policy needs HYST consecutive breached/idle
    windows before deciding (hysteresis, the real default from
    ``common/env.py``); every decision is a durable KV record advancing
    ``decide -> drain -> resize -> ack`` that a recovered driver RESUMES.
    Faults: a flash crowd arriving/receding, a spot-preemption drain, a
    worker SIGKILL, a driver crash + respawn with a lingering stale-epoch
    predecessor. Mutations re-introduce the three seeded hazards:
    ``no_hysteresis`` (single-window decisions flap), ``victim_draining``
    (scale-down picks the already-draining worker — the repeated
    preemption notice force-exits it, ``runner/elastic/preempt.py``,
    dropping its acked requests), ``no_epoch_fence`` (the fenced-out
    pre-crash driver's decision write lands after recovery)."""

    MIN, MAX = 1, 2

    def __init__(self, no_hysteresis: bool = False,
                 victim_draining: bool = False,
                 no_epoch_fence: bool = False):
        super().__init__(name="autoscale", mutations=tuple(
            m for m, on in [("no_hysteresis", no_hysteresis),
                            ("victim_draining", victim_draining),
                            ("no_epoch_fence", no_epoch_fence)] if on))
        self.no_hysteresis = no_hysteresis
        self.victim_draining = victim_draining
        self.no_epoch_fence = no_epoch_fence
        # the real hysteresis default — the spec checks the shipped
        # configuration, not an invented one
        self.hyst = 1 if no_hysteresis \
            else int(REGISTRY["HOROVOD_AUTOSCALE_UP_WINDOWS"][0])
        self.window = int(REGISTRY["HOROVOD_AUTOSCALE_UP_WINDOWS"][0])

    def initial(self) -> AutoState:
        return AutoState(
            fleet=2, spot="none", auto="none", pressure=False,
            hot=0, idle=0, since=self.window, last_dir=0, rec=None,
            epoch=1, kv_epoch=1, crashed=False, old_alive=False,
            old_rec=None, crashes_left=1, kills_left=1, spikes_left=1,
            recedes_left=1, preempts_left=1, flap=False, lost_acked=False,
            stale_applied=False, unclamped=False)

    # -- decision machinery ---------------------------------------------------

    def _tick(self, s: AutoState):
        hot = min(s.hot + 1, self.hyst) if s.pressure else 0
        idle = min(s.idle + 1, self.hyst) if not s.pressure else 0
        since = min(s.since + 1, self.window)
        ns = s._replace(hot=hot, idle=idle, since=since)
        in_flight = s.rec is not None and s.rec[1] != "ack"
        if not in_flight and hot >= self.hyst and s.fleet < self.MAX:
            flap = s.flap or (s.last_dir == -1 and since < self.window)
            return (f"autoscaler tick: {self.hyst} breached window(s) -> "
                    f"decide scale-UP (`{kv_keys.autoscale_decision()}` "
                    f"state=decide, epoch {s.epoch})",
                    ns._replace(rec=("up", "decide", s.epoch, False),
                                hot=0, idle=0, since=0, last_dir=1,
                                flap=flap))
        if not in_flight and idle >= self.hyst and s.fleet > self.MIN:
            victim_draining = self.victim_draining and \
                s.spot == "draining"
            flap = s.flap or (s.last_dir == 1 and since < self.window)
            label = (f"autoscaler tick: {self.hyst} idle window(s) -> "
                     f"decide scale-DOWN"
                     + (" (MUTATION: victim is the already-draining "
                        "worker)" if victim_draining else
                        " (victim: least-loaded accepting worker)"))
            return (label,
                    ns._replace(rec=("down", "decide", s.epoch,
                                     victim_draining),
                                hot=0, idle=0, since=0, last_dir=-1,
                                flap=flap))
        return "autoscaler tick: observe (no decision)", ns

    def actions(self, s: AutoState):
        out = []
        # -- load / environment ---------------------------------------------
        if s.spikes_left > 0 and not s.pressure:
            out.append(("flash crowd arrives (queue depth / p99 breach "
                        "the SLO bound)",
                        s._replace(pressure=True,
                                   spikes_left=s.spikes_left - 1)))
        if s.recedes_left > 0 and s.pressure:
            out.append(("load recedes (queues empty, fleet idle)",
                        s._replace(pressure=False,
                                   recedes_left=s.recedes_left - 1)))
        # -- worker-side faults ----------------------------------------------
        if s.preempts_left > 0 and s.spot == "none" and s.fleet > 1:
            out.append((
                f"fault: spot preemption notice — a worker announces "
                f"`{kv_keys.drain('host', 0)}` and stops accepting",
                s._replace(spot="draining", fleet=s.fleet - 1,
                           preempts_left=s.preempts_left - 1)))
        if s.spot == "draining":
            out.append(("spot-drained worker finishes its accepted "
                        "requests and exits 0",
                        s._replace(spot="done")))
            if s.kills_left > 0:
                out.append((
                    "fault: host dies mid-drain (draining worker "
                    "SIGKILLed; router re-routes its in-flight)",
                    s._replace(spot="done",
                               kills_left=s.kills_left - 1)))
        if s.spot == "done":
            out.append(("driver reaps the spot drain (clean departure)",
                        s._replace(spot="none")))
        if s.kills_left > 0 and s.fleet > 0:
            out.append((
                "fault: accepting worker SIGKILLed (no notice)",
                s._replace(fleet=s.fleet - 1,
                           kills_left=s.kills_left - 1)))
        # -- autoscaler + driver protocol (only while the driver lives) ------
        if not s.crashed:
            out.append(self._tick(s))
            out.extend(self._protocol(s))
        # -- driver crash / recovery -----------------------------------------
        if s.crashes_left > 0 and not s.crashed:
            lingering = s.rec is not None and s.rec[1] != "ack"
            out.append((
                "fault: driver crashes (supervisor presumes it dead; the "
                "process lingers)" if lingering else
                "fault: driver crashes",
                s._replace(crashed=True, old_alive=lingering,
                           old_rec=s.rec if lingering else None,
                           crashes_left=s.crashes_left - 1)))
        if s.crashed:
            new_epoch = s.kv_epoch + 1
            rec = s.rec
            label = (f"supervisor respawns the driver (epoch "
                     f"{s.kv_epoch} -> {new_epoch})")
            if rec is not None and rec[1] != "ack":
                rec = (rec[0], rec[1], new_epoch, rec[3])
                label += (f"; recovery RESUMES the {rec[0]} decision at "
                          f"state {rec[1]} instead of re-deciding")
            out.append((label, s._replace(
                crashed=False, epoch=new_epoch, kv_epoch=new_epoch,
                rec=rec)))
        # the fenced-out predecessor tries to finish its old decision
        if s.old_alive and s.old_rec is not None and \
                s.old_rec[2] < s.kv_epoch:
            out.append(self._stale_write(s))
        return out

    def _protocol(self, s: AutoState):
        """The driver advancing the in-flight decision record."""
        out = []
        if s.rec is None:
            return out
        action, state, epoch, victim_draining = s.rec
        if state == "decide" and action == "up":
            out.append((
                "driver acts on the decision: spawn a worker "
                "(record -> resize)",
                s._replace(rec=(action, "resize", epoch,
                                victim_draining))))
        if state == "decide" and action == "down":
            if victim_draining:
                # MUTATION path: the victim already received a spot
                # notice; a REPEATED notice force-exits immediately
                # (runner/elastic/preempt.py), dropping everything it
                # had accepted
                out.append((
                    "driver delivers a SECOND preemption notice to the "
                    "already-draining victim: it force-exits, acked "
                    "requests lost (record -> drain)",
                    s._replace(rec=(action, "drain", epoch, True),
                               spot="done", lost_acked=True)))
            elif s.fleet > 0:
                out.append((
                    "driver delivers the preemption notice: victim "
                    "stops accepting and drains (record -> drain)",
                    s._replace(rec=(action, "drain", epoch, False),
                               auto="draining", fleet=s.fleet - 1)))
        if state == "drain":
            if s.auto == "draining":
                out.append(("scale-down victim finishes its accepted "
                            "requests and exits 0",
                            s._replace(auto="done")))
            if s.auto == "done" or (victim_draining and s.spot == "done"):
                out.append((
                    "driver resize removes the drained slot "
                    "(record -> resize)",
                    s._replace(rec=(action, "resize", epoch,
                                    victim_draining),
                               auto="none")))
        if state == "resize":
            if action == "up":
                fleet = s.fleet + 1
                out.append((
                    "spawned worker joins the fleet; decision acked "
                    f"(`{kv_keys.autoscale_event(1)}` audit record)",
                    s._replace(fleet=fleet,
                               rec=(action, "ack", epoch,
                                    victim_draining),
                               unclamped=s.unclamped or
                               fleet > self.MAX)))
            else:
                out.append((
                    "scale-down resize complete; decision acked "
                    f"(`{kv_keys.autoscale_event(1)}` audit record)",
                    s._replace(rec=(action, "ack", epoch,
                                    victim_draining))))
        return out

    def _stale_write(self, s: AutoState):
        action, state, old_epoch, _ = s.old_rec
        outcome, _new = rules.admit_epoch(s.kv_epoch, old_epoch)
        if outcome == rules.FENCED and not self.no_epoch_fence:
            return (
                f"kv 409s the lingering driver's "
                f"`{kv_keys.autoscale_decision()}` write (offered epoch "
                f"{old_epoch} < current {s.kv_epoch}); it stands down",
                s._replace(old_alive=False))
        fleet = s.fleet + 1 if action == "up" else max(0, s.fleet - 1)
        return (
            f"lingering driver applies its stale {action} decision "
            f"(MUTATION: epoch fence skipped) — the fleet resizes twice "
            f"for one decision",
            s._replace(old_alive=False, fleet=fleet, stale_applied=True,
                       unclamped=s.unclamped or fleet > self.MAX or
                       fleet < 0))

    @property
    def invariants(self) -> List[Invariant]:
        return [
            Invariant(
                "no_flap",
                "no opposite-direction decisions inside one hysteresis "
                "window (a one-window spike or dip never reverses the "
                "fleet — the loop cannot oscillate)",
                lambda s: not s.flap),
            Invariant(
                "no_acked_request_loss",
                "scale-down never selects an already-draining worker "
                "(the repeated preemption notice would force-exit it and "
                "drop the requests it had accepted)",
                lambda s: not s.lost_acked),
            Invariant(
                "stale_epoch_decision_fenced",
                "a fenced-out (pre-crash) driver's scaling decision "
                "never mutates the fleet after recovery — the recovered "
                "driver resumes the record; the old one is 409'd",
                lambda s: not s.stale_applied),
            Invariant(
                "fleet_within_clamps",
                "no resize the autoscaler performs leaves the "
                "[min_workers, max_workers] interval",
                lambda s: not s.unclamped),
        ]


# ===========================================================================
# Replicated control plane: leader lease, majority replication, election
# ===========================================================================

class ReplicaState(NamedTuple):
    believes: tuple    # per replica: believes it holds a valid lease
    epoch: tuple       # per replica: adopted control epoch (term)
    log: tuple         # per replica: tuple of WAL entries, each a
    #                    (term, id) pair — the term stamps the entry
    #                    with the epoch it was appended under (the Raft
    #                    log-matching state); id > 0 is a client write,
    #                    id == -e is the lease record of the epoch-e
    #                    grant (appended at term e)
    alive: tuple       # per replica: process up
    part: tuple        # per replica: partitioned off from the others
    lease_live: bool   # the current grant's real-time window is open
    #                    (followers must wait it out before electing)
    acked: frozenset   # write ids acked to the client
    regressed: bool    # a grant's epoch failed to exceed every prior one
    writes_left: int
    retries_left: int
    kills_left: int
    parts_left: int
    heals_left: int
    elects_left: int


class ReplicaSpec(Spec):
    """Three KV replicas (``runner/replica_kv.py``), one client write +
    one retry of it (same idempotency token), modeled at the grain the
    protocol argues at: lease grants, majority-acked appends, elections,
    rejoin resync. Faults: one replica kill, one partition (isolating
    one replica), one heal. ``lease_live`` is the bounded-clock
    abstraction — while True, no correct voter grants (it is still
    inside the lease wait window); expiry requires the leaseholder dead
    or partitioned (a healthy leader keeps renewing), and the expiring
    leader **self-fences** in the same instant (its own write-path lease
    check — exactly what ``stale_lease_accepts_write`` removes).

    The election rule is the shared :func:`rules.vote_grants` /
    :func:`rules.majority` pair the real vote handler uses — the Raft
    up-to-date order over term-stamped log entries — and the lease
    record the winner replicates is IN the model (a log entry): it is
    load-bearing — a deposed leader carries at most one un-acked
    suffix record (it self-fences on the first majority-refused write),
    appended at its OLD term, while the grant record puts the winner's
    new term at the top of every majority log — which is why
    highest-(epoch, last-term, WAL-length) never elects a leader
    missing an acked write, even against an equal-*length* diverged
    rival."""

    N = 3
    WRITE = 1  # the one modeled client write id

    def __init__(self, stale_lease_accepts_write: bool = False,
                 election_without_majority: bool = False,
                 retry_double_apply: bool = False):
        super().__init__(name="replica", mutations=tuple(
            m for m, on in [
                ("stale_lease_accepts_write", stale_lease_accepts_write),
                ("election_without_majority", election_without_majority),
                ("retry_double_apply", retry_double_apply)] if on))
        self.stale_lease = stale_lease_accepts_write
        self.minority_elect = election_without_majority
        self.double_apply = retry_double_apply

    def initial(self) -> ReplicaState:
        n = self.N
        return ReplicaState(
            believes=(False,) * n, epoch=(0,) * n, log=((),) * n,
            alive=(True,) * n, part=(False,) * n, lease_live=False,
            acked=frozenset(), regressed=False,
            writes_left=1, retries_left=1, kills_left=1, parts_left=1,
            heals_left=1, elects_left=2)

    # -- helpers --------------------------------------------------------------

    def _reachable(self, s: ReplicaState, i: int) -> List[int]:
        """Peers replica i can talk to: alive, and on the same side of
        the (single modeled) partition."""
        return [j for j in range(self.N)
                if j != i and s.alive[j] and s.part[j] == s.part[i]]

    @staticmethod
    def _max_holder_epoch(s: ReplicaState) -> int:
        """Highest epoch any lease was ever granted at — recoverable
        from the persisted lease records, so not extra state."""
        return max([0] + [-eid for log in s.log
                          for _t, eid in log if eid < 0])

    @staticmethod
    def _last_term(log: tuple) -> int:
        """Term of the last WAL entry — the replica's position in the
        Raft up-to-date order (``rules.vote_grants``)."""
        return log[-1][0] if log else 0

    # -- transitions ----------------------------------------------------------

    def actions(self, s: ReplicaState):
        out = []
        for c in range(self.N):
            if s.alive[c] and not s.believes[c] and s.elects_left > 0:
                act = self._elect(s, c)
                if act is not None:
                    out.append(act)
        for i in range(self.N):
            if s.believes[i] and s.alive[i]:
                if s.writes_left > 0:
                    out.append(self._write(s, i, retry=False))
                if s.retries_left > 0 and s.writes_left == 0:
                    out.append(self._write(s, i, retry=True))
        holder_blocked = all(
            not s.believes[i] or not s.alive[i] or s.part[i]
            for i in range(self.N))
        if s.lease_live and holder_blocked:
            believes = s.believes if self.stale_lease \
                else (False,) * self.N
            label = ("lease expires; the unreachable leader self-fences "
                     "on its own expiry check"
                     if not self.stale_lease else
                     "lease expires (MUTATION: the leader's write-path "
                     "expiry check is gone — it keeps accepting)")
            out.append((label, s._replace(lease_live=False,
                                          believes=believes)))
        for i in range(self.N):
            if s.alive[i] and s.kills_left > 0:
                out.append((
                    f"fault: replica{i} SIGKILLed"
                    + (" (the leaseholder)" if s.believes[i] else ""),
                    s._replace(alive=_rep(s.alive, i, False),
                               believes=_rep(s.believes, i, False),
                               kills_left=s.kills_left - 1)))
            if s.alive[i] and not s.part[i] and s.parts_left > 0:
                out.append((
                    f"fault: replica{i} partitioned off",
                    s._replace(part=_rep(s.part, i, True),
                               parts_left=s.parts_left - 1)))
        if any(s.part) and s.heals_left > 0:
            out.append((
                "partition heals (links restored)",
                s._replace(part=(False,) * self.N,
                           heals_left=s.heals_left - 1)))
        resync = self._resync(s)
        if resync is not None:
            out.append(resync)
        return out

    def _elect(self, s: ReplicaState, c: int):
        electorate = self._reachable(s, c)
        proposed = max([s.epoch[c]] + [s.epoch[j] for j in electorate]) + 1
        votes = 1  # self
        granting = []
        for j in electorate:
            heard = s.lease_live or s.believes[j]
            if rules.vote_grants(s.epoch[j], self._last_term(s.log[j]),
                                 len(s.log[j]), proposed,
                                 self._last_term(s.log[c]),
                                 len(s.log[c]), heard):
                votes += 1
                granting.append(j)
        quorum = 1 if self.minority_elect else rules.majority(self.N)
        if votes < quorum:
            return None  # a failed solicitation changes nothing
        regressed = s.regressed or proposed <= self._max_holder_epoch(s)
        epoch = s.epoch
        log = s.log
        # the winner persists + replicates the lease record (its first
        # majority-acked append); granting voters adopt the new epoch
        for j in [c] + granting:
            epoch = _rep(epoch, j, proposed)
            log = _rep(log, j, s.log[j] + ((proposed, -proposed),))
        label = (f"replica{c} elected: epoch {proposed}, "
                 f"{votes}/{self.N} votes; lease record replicated")
        if self.minority_elect and votes < rules.majority(self.N):
            label = (f"replica{c} elects ITSELF (MUTATION: {votes} "
                     f"vote(s), no majority) at epoch {proposed}")
        return label, s._replace(
            believes=_rep(s.believes, c, True), epoch=epoch, log=log,
            lease_live=True, regressed=regressed,
            elects_left=s.elects_left - 1)

    def _write(self, s: ReplicaState, i: int, retry: bool):
        w = self.WRITE
        entry = (s.epoch[i], w)  # appended under the writer's term
        applied = any(eid == w for _t, eid in s.log[i])
        budget = {"retries_left": s.retries_left - 1} if retry \
            else {"writes_left": s.writes_left - 1}
        tag = "retried " if retry else ""
        if retry and not self.double_apply and applied:
            # the (client, seq) token was already applied here — dedupe
            # drops the replay and re-acks
            return (f"replica{i} dedupes the retried write (token "
                    f"already applied)",
                    s._replace(acked=s.acked | {w}, **budget))
        mutated = retry and self.double_apply and applied
        reachable = self._reachable(s, i)
        refused = any(s.epoch[j] > s.epoch[i] for j in reachable)
        if refused:
            # a follower on a newer term 409s the forward: the deposed
            # leader self-fences; its local append is the un-acked
            # suffix resync later truncates
            return (f"replica{i}'s {tag}write forward is 409'd by a "
                    f"newer-term follower; it self-fences",
                    s._replace(log=_rep(s.log, i, s.log[i] + (entry,)),
                               believes=_rep(s.believes, i, False),
                               **budget))
        # only a follower whose log matches the leader's accepts the
        # append (the real prev-(seq, term) check — term-stamped
        # entries make equal-length diverged logs visible); a diverged
        # one answers "resync me" and does NOT ack this round
        accepting = [j for j in reachable if s.log[j] == s.log[i]]
        if 1 + len(accepting) < rules.majority(self.N):
            return (f"replica{i}'s {tag}write cannot reach a follower "
                    f"majority; it self-fences un-acked",
                    s._replace(log=_rep(s.log, i, s.log[i] + (entry,)),
                               believes=_rep(s.believes, i, False),
                               **budget))
        log = _rep(s.log, i, s.log[i] + (entry,))
        epoch = s.epoch
        for j in accepting:
            log = _rep(log, j, s.log[j] + (entry,))
            epoch = _rep(epoch, j, max(s.epoch[j], s.epoch[i]))
        label = (f"replica{i} commits the {tag}write to a majority "
                 f"({1 + len(accepting)}/{self.N}); acked")
        if mutated:
            label = (f"replica{i} re-appends the retried write "
                     f"(MUTATION: dedupe token check skipped); acked")
        return label, s._replace(
            log=log, epoch=epoch, acked=s.acked | {w}, lease_live=True,
            **budget)

    def _resync(self, s: ReplicaState):
        """The leader's heartbeat notices a reachable diverged follower
        and ships it full state (the WAL-divergence repair path: the
        follower's un-majority-committed suffix is truncated, loudly).
        Unbudgeted — it converges (the guard disables once logs match),
        like the real ticker retriggering until the fleet agrees."""
        holder = next((i for i in range(self.N)
                       if s.believes[i] and s.alive[i]), None)
        if holder is None:
            return None
        diverged = [j for j in self._reachable(s, holder)
                    if s.log[j] != s.log[holder]]
        if not diverged:
            return None
        log, epoch = s.log, s.epoch
        for j in diverged:
            log = _rep(log, j, s.log[holder])
            epoch = _rep(epoch, j, max(s.epoch[j], s.epoch[holder]))
        return (f"leader resyncs diverged replica(s) "
                f"{diverged} (un-committed WAL suffixes truncated)",
                s._replace(log=log, epoch=epoch))

    @property
    def invariants(self) -> List[Invariant]:
        def one_leaseholder(s: ReplicaState) -> bool:
            return sum(s.believes) <= 1

        def no_acked_loss(s: ReplicaState) -> bool:
            return all(any(eid == w for _t, eid in s.log[i])
                       for i in range(self.N) if s.believes[i]
                       for w in s.acked)

        def applied_once(s: ReplicaState) -> bool:
            return all(sum(eid == self.WRITE for _t, eid in log) <= 1
                       for log in s.log)

        return [
            Invariant(
                "at_most_one_leaseholder",
                "no instant has two replicas both believing they hold "
                "the lease (two writers accepting = split brain)",
                one_leaseholder),
            Invariant(
                "no_acked_write_loss",
                "every write acked to the client is present in the "
                "current leaseholder's WAL — elections can never seat a "
                "leader missing a majority-committed record",
                no_acked_loss),
            Invariant(
                "epoch_monotonic_across_elections",
                "every lease grant's epoch strictly exceeds every "
                "earlier grant's (the fencing token never regresses)",
                lambda s: not s.regressed),
            Invariant(
                "write_applied_at_most_once",
                "a retried client op lands at most once in any "
                "replica's WAL (the idempotency-token dedupe)",
                applied_once),
        ]


# ===========================================================================
# Registries
# ===========================================================================

# ===========================================================================
# Serving fast path: block-paged KV cache ownership
# ===========================================================================

class PagedState(NamedTuple):
    free: int        # unowned pool blocks
    resident: bool   # the shared prefix block is resident in the pool
    published: bool  # it was published at least once (sticky — the hash
    #                  table entry the stale-reuse mutation consults)
    slots: tuple     # per request slot: (phase, charged, bound, shref)
    #                  phase: 0 none, 1 queued, 2 running
    qexp_left: int   # queued-expiry fault budget
    rexp_left: int   # running-expiry fault budget
    kills_left: int  # chaos-kill fault budget


_PG_NONE, _PG_QUEUED, _PG_RUNNING = 0, 1, 2


class PagedCacheSpec(Spec):
    """Block ownership in ``serve/kv_cache.py``: two request slots over a
    minimal pool (3 blocks) with one shareable prefix block.

    Every request needs 2 blocks (1 prefix + 1 private tail); admission
    *charges* the pool (or increfs the resident shared prefix and
    charges 1), the decode loop *binds* lazily, prefill *publishes* the
    prefix block as shared CoW (the publisher's private charge converts
    — conservation holds exactly), and teardown frees at a step
    boundary. Faults: queued expiry (must release, never having bound),
    running expiry (frees at the boundary where the partial output
    returns), a chaos kill mid-decode (the re-route teardown path), an
    LRU eviction of the zero-ref shared block, and drain. Mutations
    re-introduce the two seeded hazards: ``double_free_running_expiry``
    (the boundary teardown frees the charge twice — once at expiry, once
    again at finish) and ``stale_prefix_reuse`` (admission consults the
    prefix hash table without checking residency, increfing a block the
    LRU already evicted — use-after-free)."""

    POOL = 3
    SLOTS = 2

    def __init__(self, double_free_running_expiry: bool = False,
                 stale_prefix_reuse: bool = False):
        super().__init__(name="paged_cache", mutations=tuple(
            m for m, on in [("double_free_running_expiry",
                             double_free_running_expiry),
                            ("stale_prefix_reuse",
                             stale_prefix_reuse)] if on))
        self.double_free = double_free_running_expiry
        self.stale_reuse = stale_prefix_reuse
        # the model is the minimal pool exhibiting every hazard; the
        # shipped pool is configured by these registry knobs (defaults
        # asserted real so the spec can't drift from the code)
        assert int(REGISTRY["HOROVOD_SERVE_KV_POOL_BLOCKS"][0]) > 0
        assert int(REGISTRY["HOROVOD_SERVE_KV_BLOCK_TOKENS"][0]) > 0

    def initial(self) -> PagedState:
        return PagedState(
            free=self.POOL, resident=False, published=False,
            slots=((_PG_NONE, 0, 0, 0),) * self.SLOTS,
            qexp_left=1, rexp_left=1, kills_left=1)

    # -- helpers --------------------------------------------------------------

    @staticmethod
    def _refs(s: PagedState) -> int:
        return sum(sl[3] for sl in s.slots)

    def _teardown(self, s: PagedState, i: int, label: str,
                  double: bool = False) -> Tuple[str, PagedState]:
        ch = s.slots[i][1]
        freed = ch * (2 if double else 1)
        return (label, s._replace(
            free=s.free + freed,
            slots=_rep(s.slots, i, (_PG_NONE, 0, 0, 0))))

    # -- transitions ----------------------------------------------------------

    def actions(self, s: PagedState):
        out = []
        for i, (ph, ch, bd, sh) in enumerate(s.slots):
            if ph == _PG_NONE:
                # admission: charge 2 private blocks, or incref the
                # resident shared prefix and charge 1. The stale-reuse
                # mutation consults the hash table WITHOUT the residency
                # check — the entry may point at an evicted block.
                hit = s.published if self.stale_reuse else s.resident
                need = 1 if hit else 2
                if s.free >= need:
                    tag = " (MUTATION: stale hash entry, block evicted)" \
                        if hit and not s.resident else \
                        (" (shared-prefix hit, incref)" if hit else "")
                    out.append((
                        f"slot {i}: admit charges {need} block(s)"
                        f"{tag}",
                        s._replace(free=s.free - need,
                                   slots=_rep(s.slots, i,
                                              (_PG_QUEUED, need, 0,
                                               1 if hit else 0)))))
            elif ph == _PG_QUEUED:
                out.append((
                    f"slot {i}: scheduled into the batch",
                    s._replace(slots=_rep(s.slots, i,
                                          (_PG_RUNNING, ch, bd, sh)))))
                if s.qexp_left > 0:
                    out.append(self._teardown(
                        s._replace(qexp_left=s.qexp_left - 1), i,
                        f"slot {i}: deadline passes while QUEUED — "
                        f"release the charge (never bound a block)"))
            elif ph == _PG_RUNNING:
                if bd < ch:
                    # decode step: bind the charged blocks; prefill
                    # publishes the prefix block as shared CoW (the
                    # publisher's private charge converts to the shared
                    # population — pool conservation is exact)
                    if sh == 0 and not s.resident:
                        out.append((
                            f"slot {i}: prefill step binds + PUBLISHES "
                            f"the prefix block (private -> shared CoW)",
                            s._replace(
                                resident=True, published=True,
                                slots=_rep(s.slots, i,
                                           (_PG_RUNNING, ch - 1, ch - 1,
                                            1)))))
                    else:
                        out.append((
                            f"slot {i}: decode step binds {ch} block(s)",
                            s._replace(slots=_rep(s.slots, i,
                                                  (_PG_RUNNING, ch, ch,
                                                   sh)))))
                else:
                    out.append(self._teardown(
                        s, i,
                        f"slot {i}: completes — frees {ch} charged "
                        f"block(s) at the step boundary, decref shared"))
                    if s.rexp_left > 0:
                        lbl = (f"slot {i}: deadline passes mid-decode — "
                               f"partial output returned, {ch} block(s) "
                               f"freed at the step boundary")
                        if self.double_free:
                            lbl += (" (MUTATION: freed again at finish "
                                    "— double free)")
                        out.append(self._teardown(
                            s._replace(rexp_left=s.rexp_left - 1), i,
                            lbl, double=self.double_free))
                    if s.kills_left > 0:
                        out.append(self._teardown(
                            s._replace(kills_left=s.kills_left - 1), i,
                            f"slot {i}: CHAOS KILL mid-decode — router "
                            f"re-routes, teardown frees {ch} block(s)"))
        if s.resident and self._refs(s) == 0:
            out.append((
                "LRU evicts the zero-ref shared prefix block",
                s._replace(resident=False, free=s.free + 1)))
        active = [i for i, sl in enumerate(s.slots)
                  if sl[0] != _PG_NONE]
        if active:
            ns = s
            for i in active:
                _lbl, ns = self._teardown(
                    ns, i, "")
            out.append((
                f"drain: slot(s) {active} finish and free their charges",
                ns))
        return out

    @property
    def invariants(self) -> List[Invariant]:
        pool = self.POOL

        def conserved(s: PagedState) -> bool:
            return s.free + sum(sl[1] for sl in s.slots) + \
                (1 if s.resident else 0) == pool

        return [
            Invariant(
                "charge_free_balance",
                "pool conservation: free + charged(private) + "
                "resident(shared) == pool at every step boundary — a "
                "double free (or a leak) breaks the ledger",
                conserved),
            Invariant(
                "no_use_after_free",
                "no live request holds a reference to an evicted shared "
                "block (admission must re-check residency, not just the "
                "hash table)",
                lambda s: self._refs(s) == 0 or s.resident),
            Invariant(
                "queued_never_binds",
                "a queued request owns charged capacity only — it never "
                "binds a physical block (the expiry split: queued "
                "expiry releases, it has nothing to free)",
                lambda s: all(sl[2] == 0 for sl in s.slots
                              if sl[0] == _PG_QUEUED)),
            Invariant(
                "no_aliasing",
                "a block has one owner: bound never exceeds charged and "
                "the free count never goes negative (aliasing between "
                "live requests shows up as either)",
                lambda s: s.free >= 0 and
                all(sl[2] <= sl[1] for sl in s.slots)),
        ]


# ===========================================================================
# Tiered telemetry scrape (per-host aggregator + driver fallback)
# ===========================================================================

class ScrapeState(NamedTuple):
    c: int                # the rank's live counter value (this incarnation)
    avail: int            # increments that occurred while a driver
    #                       baseline existed (upper bound for T)
    a_val: Optional[int]  # aggregator's cached snapshot of c (None: none)
    a_stale: bool         # payload older than the staleness bound (dead)
    a_old: bool           # payload predates the driver's last direct
    #                       consume (age-fresh but window-regressed)
    b: Optional[int]      # driver baseline for the rank (metrics_prev)
    b_gen: int            # generation the baseline was established in
    T: int                # driver-visible accumulated counter delta
    gen: int              # driver topology generation
    stale_baseline_used: bool  # a heartbeat diffed against a baseline
    #                            from an older generation
    incs_left: int
    deaths_left: int
    gens_left: int


class ScrapeSpec(Spec):
    """One host, one rank, both scrape tiers (``metrics/aggregator.py``
    ``TieredScrape``).

    The rank owns a monotonic counter; the per-host aggregator caches a
    snapshot of it (``/agg.json``); the driver's heartbeat consumes the
    host through EXACTLY one path per beat — the aggregator when its
    payload is fresh and not window-regressed, the direct per-rank
    scrape otherwise — diffing into one shared baseline. Faults: the
    aggregator crashes (payload goes stale), and a generation change
    restarts the rank (counter back to zero) while the driver clears
    its baselines exactly once (``_rebalance``).

    Invariants:

    - ``no_double_count`` — the driver-visible accumulated delta never
      exceeds the true increment count. Killed by
      ``double_count_on_fallback`` (one heartbeat consumes the host via
      BOTH paths against the same baseline) and by
      ``consume_stale_window`` (an age-fresh aggregator payload that
      predates the last direct consume regresses the baseline, and the
      next window re-counts the difference — the hazard the
      ``TieredScrape`` per-host window floor exists to stop);
    - ``baseline_reset_on_generation`` — no heartbeat ever diffs against
      a baseline established under an older generation. Killed by
      ``skip_baseline_reset`` (the generation change keeps the baseline
      maps — the stale-baseline bug via the aggregator tier).

    Monotonicity of the driver-visible total is structural (deltas are
    only ever added when positive), so it needs no separate invariant.
    """

    def __init__(self, double_count_on_fallback: bool = False,
                 skip_baseline_reset: bool = False,
                 consume_stale_window: bool = False,
                 incs: int = 3, deaths: int = 1, gens: int = 1):
        super().__init__(name="scrape", mutations=tuple(
            m for m, on in [
                ("double_count_on_fallback", double_count_on_fallback),
                ("skip_baseline_reset", skip_baseline_reset),
                ("consume_stale_window", consume_stale_window)] if on))
        self.double_count_on_fallback = double_count_on_fallback
        self.skip_baseline_reset = skip_baseline_reset
        self.consume_stale_window = consume_stale_window
        self.incs = incs
        self.deaths = deaths
        self.gens = gens

    def initial(self) -> ScrapeState:
        return ScrapeState(
            c=0, avail=0, a_val=None, a_stale=False, a_old=False,
            b=None, b_gen=0, T=0, gen=0, stale_baseline_used=False,
            incs_left=self.incs, deaths_left=self.deaths,
            gens_left=self.gens)

    # one consume = TieredScrape._consume_rank: establish or diff the
    # shared baseline (the same code path for both tiers).  Establishing
    # from a snapshot v absorbs increments [0, v] forever, but anything
    # the rank did above v is countable later — credit it to ``avail``
    # (matters when establishing from an aggregator payload older than
    # the rank's live counter).
    def _consume(self, s: ScrapeState, v: int) -> ScrapeState:
        if s.b is None:
            return s._replace(b=v, b_gen=s.gen, avail=s.avail + (s.c - v))
        stale = s.stale_baseline_used or s.b_gen != s.gen
        delta = v - s.b if v > s.b else 0
        return s._replace(b=v, T=s.T + delta, stale_baseline_used=stale)

    def actions(self, s: ScrapeState):
        out = []
        if s.incs_left > 0:
            out.append(("rank.inc", s._replace(
                c=s.c + 1, avail=s.avail + (1 if s.b is not None else 0),
                incs_left=s.incs_left - 1)))
        # aggregator refresh: snapshot the rank NOW; a fresh window
        # clears both the staleness and the regression marks
        out.append(("agg.refresh", s._replace(
            a_val=s.c, a_stale=False, a_old=False)))
        if s.deaths_left > 0 and s.a_val is not None and not s.a_stale:
            out.append(("fault: aggregator crashes mid-heartbeat "
                        "(payload ages past the staleness bound)",
                        s._replace(a_stale=True,
                                   deaths_left=s.deaths_left - 1)))
        # driver heartbeat — exactly one path per beat in the clean spec
        agg_usable = s.a_val is not None and not s.a_stale and \
            (not s.a_old or self.consume_stale_window)
        if agg_usable:
            out.append(("driver.heartbeat(agg)", self._consume(s, s.a_val)))
        # direct scrape: the mandatory path when the aggregator tier is
        # unusable, and always reachable via a transient agg-fetch
        # failure (KV miss / connection refused) even when it is.
        # Either way, any still-cached aggregator payload now predates
        # this consume — window-regressed from here on (the real
        # TieredScrape records this as the per-host window floor).
        nxt = self._consume(s, s.c)
        if nxt.a_val is not None:
            nxt = nxt._replace(a_old=True)
        out.append(("driver.heartbeat(direct fallback)", nxt))
        if self.double_count_on_fallback and agg_usable \
                and s.b is not None:
            # seeded bug: the fallback leg runs after the aggregator leg
            # in the SAME heartbeat, both diffing the baseline read at
            # heartbeat start
            d1 = s.a_val - s.b if s.a_val > s.b else 0
            d2 = s.c - s.b if s.c > s.b else 0
            stale = s.stale_baseline_used or s.b_gen != s.gen
            out.append(("driver.heartbeat(BOTH paths)", s._replace(
                b=s.c, T=s.T + d1 + d2, stale_baseline_used=stale)))
        if s.gens_left > 0:
            # elastic resize: the rank restarts (counter from zero), the
            # aggregator's old payload dies with its worker, and the
            # driver clears its baselines exactly once (_rebalance) —
            # unless the seeded mutant skips the clear
            nxt = s._replace(c=0, a_val=None, a_stale=False, a_old=False,
                             gen=s.gen + 1, gens_left=s.gens_left - 1)
            if not self.skip_baseline_reset:
                nxt = nxt._replace(b=None, b_gen=nxt.gen)
            out.append(("driver.rebalance(generation change)", nxt))
        return out

    @property
    def invariants(self) -> List[Invariant]:
        return [
            Invariant(
                "no_double_count",
                "the driver-visible accumulated counter delta never "
                "exceeds the increments that actually occurred while a "
                "baseline existed — a rank is consumed through exactly "
                "one scrape path per window",
                lambda s: s.T <= s.avail),
            Invariant(
                "baseline_reset_on_generation",
                "no heartbeat diffs against a baseline established "
                "under an older generation (the generation change "
                "clears the shared baseline maps exactly once)",
                lambda s: not s.stale_baseline_used),
        ]


# ===========================================================================
# Durable event journal (common/journal.py)
# ===========================================================================

class JournalState(NamedTuple):
    buffered: tuple        # (comp, seq) appended, not yet durable
    active_durable: tuple  # flushed records still in the active segment
    closed_segs: tuple     # closed segments, oldest first (tuples of events)
    acked: frozenset       # events whose emitter was told "recorded"
    retired: frozenset     # retention-deleted (closed segments only)
    lost: frozenset        # gone without ever becoming durable
    crashed: bool          # the writer process died (buffer gone)
    next_seq: tuple        # per-component next sequence number
    appends_left: int
    rotations_left: int
    crashes_left: int


class JournalSpec(Spec):
    """One journal writer appending events for two components, with
    segment rotation, closed-segment retention, and a crash that loses
    whatever is buffered but not flushed. The durable order — closed
    segments oldest-first, then the active segment's flushed records —
    is exactly what :func:`common.journal.iter_journal` replays and what
    ``hvd-check --conformance``'s journal auditor checks on real
    artifacts.

    Mutations re-introduce the three ways a journal silently lies:
    acking before the flush (a crash then loses an acked event), seq
    reset at rotation (replay order becomes ambiguous across segments),
    and rotation closing the active segment without flushing its tail
    (durable-looking records evaporate with no crash at all)."""

    COMPONENTS = ("driver", "serve")

    def __init__(self, appends: int = 4, rotations: int = 2,
                 crashes: int = 1, keep: int = 1,
                 ack_before_flush: bool = False,
                 seq_reset_on_rotate: bool = False,
                 rotate_skip_flush: bool = False):
        super().__init__(name="journal", mutations=tuple(
            m for m, on in [("ack_before_flush", ack_before_flush),
                            ("seq_reset_on_rotate", seq_reset_on_rotate),
                            ("rotate_skip_flush", rotate_skip_flush)]
            if on))
        self.appends = appends
        self.rotations = rotations
        self.crashes = crashes
        self.keep = keep  # retention: closed segments retained
        self.ack_before_flush = ack_before_flush
        self.seq_reset_on_rotate = seq_reset_on_rotate
        self.rotate_skip_flush = rotate_skip_flush

    def initial(self) -> JournalState:
        return JournalState(
            buffered=(), active_durable=(), closed_segs=(),
            acked=frozenset(), retired=frozenset(), lost=frozenset(),
            crashed=False, next_seq=(0,) * len(self.COMPONENTS),
            appends_left=self.appends, rotations_left=self.rotations,
            crashes_left=self.crashes)

    @staticmethod
    def _durable_order(s: JournalState) -> tuple:
        out: tuple = ()
        for seg in s.closed_segs:
            out += seg
        return out + s.active_durable

    def actions(self, s: JournalState):
        out = []
        if s.appends_left > 0 and not s.crashed:
            for ci, comp in enumerate(self.COMPONENTS):
                seq = s.next_seq[ci]
                ev = (comp, seq)
                nxt = s._replace(
                    buffered=s.buffered + (ev,),
                    next_seq=_rep(s.next_seq, ci, seq + 1),
                    appends_left=s.appends_left - 1)
                if self.ack_before_flush:
                    # the seeded lie: the emitter hears "recorded"
                    # while the record is still a volatile buffer
                    nxt = nxt._replace(acked=nxt.acked | {ev})
                out.append((f"append({comp}, seq={seq})", nxt))
        if s.buffered and not s.crashed:
            out.append(("flush(ack)", s._replace(
                buffered=(),
                active_durable=s.active_durable + s.buffered,
                acked=s.acked | frozenset(s.buffered))))
        if s.rotations_left > 0 and not s.crashed and \
                (s.active_durable or s.buffered):
            if self.rotate_skip_flush:
                # seeded bug: close the active segment without flushing
                # its tail — the buffered records just evaporate
                nxt = s._replace(
                    buffered=(), lost=s.lost | frozenset(s.buffered),
                    active_durable=(),
                    closed_segs=s.closed_segs + (s.active_durable,),
                    rotations_left=s.rotations_left - 1)
            else:
                nxt = s._replace(
                    buffered=(), active_durable=(),
                    acked=s.acked | frozenset(s.buffered),
                    closed_segs=s.closed_segs +
                    (s.active_durable + s.buffered,),
                    rotations_left=s.rotations_left - 1)
            if self.seq_reset_on_rotate:
                nxt = nxt._replace(
                    next_seq=(0,) * len(self.COMPONENTS))
            out.append(("rotate(flush+close)", nxt))
        if len(s.closed_segs) > self.keep:
            # retention prunes oldest CLOSED segments only; the active
            # segment is structurally out of reach
            out.append(("retention.delete(oldest closed)", s._replace(
                closed_segs=s.closed_segs[1:],
                retired=s.retired | frozenset(s.closed_segs[0]))))
        if s.crashes_left > 0 and s.buffered and not s.crashed:
            out.append(("crash(buffer lost)", s._replace(
                buffered=(), lost=s.lost | frozenset(s.buffered),
                crashed=True, crashes_left=s.crashes_left - 1,
                appends_left=0)))
        return out

    @property
    def invariants(self) -> List[Invariant]:
        def no_lost_acked(s: JournalState) -> bool:
            durable = set(self._durable_order(s))
            return all(e in durable or e in s.retired for e in s.acked)

        def seq_monotone(s: JournalState) -> bool:
            last: Dict[str, int] = {}
            for comp, seq in self._durable_order(s):
                if comp in last and seq <= last[comp]:
                    return False
                last[comp] = seq
            return True

        return [
            Invariant(
                "no_lost_acked_event",
                "every acked event is durable (flushed segment) or was "
                "retired by retention after being durable — never "
                "sitting in a volatile buffer a crash can take",
                no_lost_acked),
            Invariant(
                "per_component_seq_monotone",
                "the durable replay order (closed segments oldest-"
                "first, then the active segment) carries strictly "
                "increasing seq per component — the property the "
                "journal auditor checks on real artifacts",
                seq_monotone),
            Invariant(
                "rotation_never_drops_unflushed",
                "no event is ever lost without a crash: rotation "
                "flushes the active tail before closing, and retention "
                "only deletes closed (fully durable) segments",
                lambda s: not s.lost or s.crashed),
        ]


SPECS: Dict[str, type] = {
    "cycle": CycleSpec,
    "epoch": EpochSpec,
    "drain": DrainSpec,
    "tune": TuneSpec,
    "autoscale": AutoscaleSpec,
    "paged_cache": PagedCacheSpec,
    "scrape": ScrapeSpec,
    "replica": ReplicaSpec,
    "journal": JournalSpec,
}

# mutant name -> (spec name, constructor kwarg, description). Each is a
# seeded historical bug (or a deliberate weakening proving an invariant
# has teeth); `hvd-check --mutant <name>` must find a counterexample.
MUTANTS: Dict[str, Tuple[str, str, str]] = {
    "drain_scan_after_refresh": (
        "drain", "scan_after_refresh",
        "same-heartbeat drain race: the heartbeat refreshed "
        "discovery before scanning drain keys, so a rebalance could "
        "place onto a host whose drain was already announced"),
    "drain_no_last_chance": (
        "drain", "no_last_chance",
        "without the reap-time last-chance KV/registry "
        "check, a fast drain's exit 0 reads as job completion"),
    "drain_no_buddy": (
        "drain", "no_buddy",
        "commit-time ring-buddy replication removed: a kill between "
        "commit and handoff loses the acknowledged shard"),
    "epoch_accept_stale_notify": (
        "epoch", "accept_stale_notify",
        "a worker without the epoch floor accepts a "
        "fenced-out pre-crash driver's stale notify and resets backward "
        "into an older generation"),
    "epoch_no_fence": (
        "epoch", "no_fence",
        "KV-side 409 fencing removed: a lingering older-epoch driver's "
        "mutation lands after the recovered driver's (split-brain)"),
    "epoch_no_adoption_check": (
        "epoch", "no_adoption_check",
        "driver recovery spawns every expected slot without the "
        "heartbeat adoption check: live workers get double-spawned"),
    "cycle_rank_divergent_express": (
        "cycle", "rank_divergent_express",
        "rank-divergent express-lane partition (serving-mode hazard "
        "class): ranks peel different response sets onto the express "
        "lane and execute collectives in different orders"),
    "cycle_abort_ignored": (
        "cycle", "ignore_abort",
        "the negotiation round's except swallows the backend error "
        "instead of failing every waiter through _fail_all: a crashed or "
        "aborted peer is never honored and rounds keep negotiating past "
        "it"),
    "tune_apply_inline": (
        "tune", "apply_inline",
        "TunedParams applied inline at push instead of staged for rank "
        "0's next round message: rank 0 runs different knobs than its "
        "peers mid-round"),
    "tune_env_divergent_thresholds": (
        "tune", "env_divergent_thresholds",
        "a rank seeds its fusion or low-latency threshold from its own "
        "HOROVOD_FUSION_THRESHOLD / HOROVOD_LOW_LATENCY_THRESHOLD instead "
        "of adopting rank 0's push — two ranks cut different fused "
        "batches and their collectives no longer match (the port's "
        "counterpart of tune_env_divergent_routing)"),
    "autoscale_no_hysteresis": (
        "autoscale", "no_hysteresis",
        "hysteresis windows removed: the policy decides on a single "
        "breached/idle observation, so a spike-then-dip flips the fleet "
        "in opposite directions inside one window (flapping)"),
    "autoscale_victim_draining": (
        "autoscale", "victim_draining",
        "scale-down victim selection stops excluding draining workers: "
        "the repeated preemption notice force-exits the already-draining "
        "victim (runner/elastic/preempt.py) and its acked requests are "
        "lost"),
    "autoscale_stale_epoch_decision": (
        "autoscale", "no_epoch_fence",
        "KV epoch fence removed from autoscale decision writes: after "
        "driver recovery the lingering pre-crash driver applies its "
        "stale decision and the fleet resizes twice for one decision"),
    "paged_double_free_running_expiry": (
        "paged_cache", "double_free_running_expiry",
        "running-expiry teardown frees the request's charged blocks at "
        "the step boundary AND again at finish: the pool ledger "
        "over-credits and a later admission aliases live blocks"),
    "paged_stale_prefix_reuse": (
        "paged_cache", "stale_prefix_reuse",
        "admission consults the prefix hash table without re-checking "
        "residency: it increfs a shared block the LRU already evicted "
        "and the request decodes from a freed page (use-after-free)"),
    "scrape_double_count_on_fallback": (
        "scrape", "double_count_on_fallback",
        "the heartbeat's direct-fallback leg runs AFTER the aggregator "
        "leg in the same beat, both diffing the baseline read at "
        "heartbeat start: every relayed increment lands twice in the "
        "driver's totals"),
    "scrape_baseline_reset_skipped": (
        "scrape", "skip_baseline_reset",
        "stale-baseline bug resurfacing through the aggregator "
        "tier: the generation change keeps metrics_prev, so the first "
        "post-rebalance heartbeat diffs a restarted rank against a "
        "dead incarnation's counters"),
    "replica_stale_lease_accepts_write": (
        "replica", "stale_lease_accepts_write",
        "the leader's write-path lease-expiry check removed: a slow "
        "(paused/partitioned) leader keeps accepting writes after its "
        "lease lapsed, so once a successor is elected two replicas "
        "accept writes at the same instant (split brain)"),
    "replica_election_without_majority": (
        "replica", "election_without_majority",
        "the election quorum check removed: a partitioned minority "
        "replica elects itself on its own vote, producing a second "
        "simultaneous leaseholder at a non-advancing epoch"),
    "replica_retry_double_apply": (
        "replica", "retry_double_apply",
        "the (client, seq) idempotency-token dedupe removed: a client "
        "retry after a timed-out-but-committed write re-appends the "
        "same op, which lands twice in every replica's WAL"),
    "journal_ack_before_flush": (
        "journal", "ack_before_flush",
        "journal append acks the emitter before the segment flush: a "
        "crash in the gap loses an event the caller was told is "
        "durable, so hvd-doctor's timeline silently misses the acked "
        "evidence"),
    "journal_seq_reset_on_rotate": (
        "journal", "seq_reset_on_rotate",
        "the per-writer sequence counter restarts at segment rotation: "
        "replayed seqs regress across the segment boundary and the "
        "journal auditor's per-component monotonicity (the doctor's "
        "tie-breaking order) is violated"),
    "journal_rotate_skip_flush": (
        "journal", "rotate_skip_flush",
        "rotation closes the active segment without flushing its "
        "buffered tail: records evaporate with no crash anywhere — the "
        "rotation-never-drops-an-unflushed-segment rule is violated"),
    "scrape_consume_stale_window": (
        "scrape", "consume_stale_window",
        "the per-host window floor removed: an age-fresh /agg.json "
        "payload sampled BEFORE the driver's last direct consume "
        "regresses the shared baseline, and the next window re-counts "
        "the difference"),
}


def make_spec(name: str, mutant: Optional[str] = None) -> Spec:
    """Instantiate a spec, optionally with one seeded mutation."""
    if mutant is not None:
        spec_name, kwarg, _ = MUTANTS[mutant]
        if name not in (None, spec_name):
            raise ValueError(f"mutant {mutant} belongs to spec "
                             f"{spec_name}, not {name}")
        return SPECS[spec_name](**{kwarg: True})
    return SPECS[name]()
