"""Runtime trace conformance: replay real artifacts against the protocol
rules.

Counterpart of ``horovod_tpu/verify/conformance.py``, copied (the
port's model checker beside it, ``specs.py``, argues about the same
protocols from the other side). Three artifact classes,
all produced by ordinary operation (no special tracing mode):

- **KV write-ahead logs** (``HOROVOD_KV_DIR/wal.log`` + snapshot, and the
  per-shard ``wal-<shard>.log``) — every control-plane mutation in commit
  order. Replayed read-only (unlike ``_Wal.replay`` this parser never
  truncates the artifact) and checked against the typed key registry
  (``common/kv_keys.py``), the epoch-monotonicity rule, and the go-barrier
  ordering (``go/gN`` only after generation N's topology).
- **Flight-recorder dumps** (``flight_rank<R>.json``) — each rank's
  collective lifecycle ring. Checked for the cross-rank invariants:
  exec-order agreement and signature agreement, plus any recorded DESYNC
  events.
- **Event journals** (``journal_*.log``) — per-writer sequence, epoch and
  generation monotonicity.

The flight analyzer (``profiler/flight.py``) appends the flight check's
lines to its verdict, and ``obs/doctor.py`` runs all three.
"""

from __future__ import annotations

import base64
import json
import os
import zlib
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from horovod_tpu_torch.common import kv_keys

_MAX_RECORD_BYTES = 64 << 20  # mirrors runner/http_kv.py's replay ceiling


# ===========================================================================
# KV WAL replay (read-only)
# ===========================================================================

def iter_wal_ops(kv_dir, wal_file: str = "wal.log") -> Iterator[dict]:
    """Yield the decoded JSON ops of one WAL file in commit order,
    stopping (like the real replay) at the first truncated or corrupt
    record — but never mutating the artifact."""
    path = Path(kv_dir) / wal_file
    try:
        data = path.read_bytes()
    except OSError:
        return
    off = 0
    while off + 8 <= len(data):
        length = int.from_bytes(data[off:off + 4], "little")
        crc = int.from_bytes(data[off + 4:off + 8], "little")
        if length <= 0 or length > _MAX_RECORD_BYTES or \
                off + 8 + length > len(data):
            return
        payload = data[off + 8:off + 8 + length]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return
        try:
            yield json.loads(payload)
        except ValueError:
            return
        off += 8 + length


def load_snapshot_keys(kv_dir, snap_file: str = "snapshot.json") \
        -> List[str]:
    """Keys present in a compacted snapshot (compaction truncates the
    WAL, so ordering checks must treat snapshot contents as 'already
    seen')."""
    path = Path(kv_dir) / snap_file
    try:
        doc = json.loads(path.read_bytes())
        return list(doc.get("store", {}))
    except (OSError, ValueError, AttributeError):
        return []


def _decoded_value(op: dict) -> Optional[dict]:
    try:
        val = json.loads(base64.b64decode(op.get("v", "")))
    except (ValueError, TypeError):
        return None
    return val if isinstance(val, dict) else None


_GENERATION_FAMILIES = ("generation", "notify", "agg_targets")


def _audit_stream(ops: List[dict], label: str, seen_keys: set,
                  shard: Optional[str] = None,
                  check_go: bool = True) -> List[str]:
    """Audit one WAL's op stream against the protocol rules. ``shard``
    (non-core shard WALs only) additionally enforces the kv_keys shard
    routing — a heartbeat record in the serve WAL is a divergence; the
    core WAL is exempt because it is also the legacy pre-sharding log
    and may replay anything."""
    out: List[str] = []
    max_claimed_epoch: Optional[int] = None
    max_generation: Optional[int] = None
    for i, op in enumerate(ops):
        kind = op.get("op")
        # op-level epoch claim (recorded by KVServer._log_op): the
        # strongest split-brain oracle — EVERY admitted claim must be
        # monotone, whatever key it touched
        claimed = op.get("e")
        if claimed is not None:
            e = int(claimed)
            if max_claimed_epoch is not None and e < max_claimed_epoch:
                out.append(
                    f"{label}[{i}]: op claimed control epoch {e} after "
                    f"{max_claimed_epoch} was admitted — a fenced-out "
                    "stale driver's mutation landed (split-brain)")
            max_claimed_epoch = max(max_claimed_epoch or e, e)
        if kind == "lease":
            continue  # replica lease grant: the epoch claim above is
            # its whole conformance contract (no store mutation)
        if kind == "delp":
            prefix = op.get("p", "")
            if kv_keys.match_prefix(prefix) is None:
                out.append(f"{label}[{i}]: delete_prefix of unregistered "
                           f"key namespace {prefix!r}")
            seen_keys -= {k for k in seen_keys if k.startswith(prefix)}
            continue
        key = op.get("k", "")
        m = kv_keys.match(key)
        if m is None:
            out.append(f"{label}[{i}]: key {key!r} matches no registered "
                       "family (common/kv_keys.py)")
            continue
        family, _args = m
        fam = kv_keys.FAMILIES[family]
        if shard is not None and fam.shard != shard:
            out.append(
                f"{label}[{i}]: key {key!r} routes to shard "
                f"{fam.shard!r} but was recorded in the {shard!r} WAL — "
                "shard routing divergence")
        if kind == "del":
            seen_keys.discard(key)
            continue
        seen_keys.add(key)
        val = _decoded_value(op)
        if fam.epoch_claimed and isinstance(val, dict) and \
                "epoch" in val:
            try:
                e = int(val["epoch"])
            except (TypeError, ValueError):
                out.append(f"{label}[{i}]: {key}: non-integer epoch "
                           f"{val['epoch']!r}")
                continue
            if max_claimed_epoch is not None and e < max_claimed_epoch:
                out.append(
                    f"{label}[{i}]: {key}: control epoch regressed "
                    f"({e} after {max_claimed_epoch}) — a fenced-out "
                    "stale driver's write landed (split-brain)")
            max_claimed_epoch = max(max_claimed_epoch or e, e)
        if family in _GENERATION_FAMILIES \
                and isinstance(val, dict) and "generation" in val:
            try:
                g = int(val["generation"])
            except (TypeError, ValueError):
                g = None
            if g is not None:
                if max_generation is not None and g < max_generation:
                    out.append(
                        f"{label}[{i}]: {key}: generation regressed "
                        f"({g} after {max_generation})")
                max_generation = max(max_generation or g, g)
        if check_go and family == "go":
            gen = kv_keys.FAMILIES["go"].regex.match(key).group("gen")
            prefix = kv_keys.rank_and_size_prefix(int(gen))
            if not any(k.startswith(prefix) for k in seen_keys):
                out.append(
                    f"{label}[{i}]: {key}: go barrier released before "
                    f"any {prefix}* topology record existed")
    return out


def _audit_cross_shard(ops: List[dict]) -> List[str]:
    """Epoch + generation monotonicity over the MERGED commit order (the
    server-global ``"s"`` sequence) — per-shard audits can each be clean
    while a stale driver's writes interleave regressively across shards."""
    out: List[str] = []
    max_e: Optional[int] = None
    max_gen: Optional[int] = None
    for op in ops:
        claimed = op.get("e")
        if claimed is not None:
            e = int(claimed)
            if max_e is not None and e < max_e:
                out.append(
                    f"cross-shard s={op['s']}: op claimed control epoch "
                    f"{e} after {max_e} was admitted in another shard — "
                    "a fenced-out stale driver's mutation landed "
                    "(split-brain)")
            max_e = max(max_e or e, e)
        if op.get("op") != "put":
            continue
        m = kv_keys.match(op.get("k", ""))
        if m is None or m[0] not in _GENERATION_FAMILIES:
            continue
        val = _decoded_value(op)
        if isinstance(val, dict) and "generation" in val:
            try:
                g = int(val["generation"])
            except (TypeError, ValueError):
                continue
            if max_gen is not None and g < max_gen:
                out.append(
                    f"cross-shard s={op['s']}: {op['k']}: generation "
                    f"regressed ({g} after {max_gen}) across shards")
            max_gen = max(max_gen or g, g)
    return out


def check_kv_wal(kv_dir) -> List[str]:
    """Divergences between a KV's write-ahead logs and the protocol
    rules. Empty list = conformant. Each shard's WAL (``wal.log`` for
    core, ``wal-<shard>.log`` otherwise) is audited independently, then
    the ``"s"``-stamped ops of every shard are merged back into the
    server-global commit order for the cross-shard epoch/generation
    monotonicity pass."""
    out: List[str] = []
    kv_dir = Path(kv_dir)
    shard_files = {"core": ("wal.log", "snapshot.json")}
    for f in sorted(kv_dir.glob("wal-*.log")):
        shard = f.name[len("wal-"):-len(".log")]
        shard_files[shard] = (f.name, f"snapshot-{shard}.json")
    for f in sorted(kv_dir.glob("snapshot-*.json")):
        shard = f.name[len("snapshot-"):-len(".json")]
        shard_files.setdefault(shard, (f"wal-{shard}.log", f.name))
    any_artifact = False
    populated = 0
    all_stamped: List[dict] = []
    for shard, (wal_file, snap_file) in shard_files.items():
        if (kv_dir / wal_file).exists() or (kv_dir / snap_file).exists():
            any_artifact = True
        ops = list(iter_wal_ops(kv_dir, wal_file))
        if ops:
            populated += 1
        all_stamped += [op for op in ops if isinstance(op.get("s"), int)]
        seen_keys = set(load_snapshot_keys(kv_dir, snap_file))
        label = "wal" if shard == "core" else f"wal-{shard}"
        out += _audit_stream(ops, label, seen_keys,
                             shard=None if shard == "core" else shard,
                             check_go=(shard == "core"))
    if populated > 1:
        all_stamped.sort(key=lambda op: op["s"])
        out += _audit_cross_shard(all_stamped)
    if not any_artifact:
        out.append(f"{kv_dir}: no wal.log or snapshot.json — not a "
                   "durable KV directory")
    return out


# ===========================================================================
# Flight-dump replay
# ===========================================================================

def _exec_sequence(dump: dict) -> List[Tuple[str, int]]:
    """One rank's executed collectives, in execution order: the order of
    their EXEC timestamps (the express lane reorders execution relative
    to enqueue, identically on every rank)."""
    from horovod_tpu_torch.profiler.flight import reconstruct
    execd = [c for c in reconstruct(dump) if "EXEC" in c.phases
             or "DONE" in c.phases]
    execd.sort(key=lambda c: c.phases.get("EXEC",
                                          c.phases.get("DONE", 0.0)))
    return [(c.name, c.occurrence) for c in execd]


def check_flight_dumps(dumps: Dict[int, dict]) -> List[str]:
    """Cross-rank divergences in a set of per-rank flight dumps (the
    output of ``profiler.flight.load_dumps``). Empty list = the recorded
    run conforms to the cycle spec's invariants."""
    from horovod_tpu_torch.profiler.flight import reconstruct
    out: List[str] = []
    seqs = {r: _exec_sequence(d) for r, d in dumps.items()}
    ranks = sorted(seqs)
    for i in range(len(ranks)):
        for j in range(i + 1, len(ranks)):
            a, b = seqs[ranks[i]], seqs[ranks[j]]
            common = set(a) & set(b)
            fa = [x for x in a if x in common]
            fb = [x for x in b if x in common]
            if fa != fb:
                # name the first divergence point, not the whole logs
                k = next((n for n, (x, y) in enumerate(zip(fa, fb))
                          if x != y), min(len(fa), len(fb)))
                out.append(
                    f"exec-order divergence between rank {ranks[i]} and "
                    f"rank {ranks[j]} at common position {k}: "
                    f"{fa[k][0] if k < len(fa) else '<end>'} vs "
                    f"{fb[k][0] if k < len(fb) else '<end>'} — the "
                    "cross-rank exec-order invariant (cycle spec) is "
                    "violated")
    # signature agreement + recorded desyncs
    sigs: Dict[Tuple[str, int], Dict[int, int]] = {}
    for r, d in dumps.items():
        for c in reconstruct(d):
            if c.signature:
                sigs.setdefault((c.name, c.occurrence), {})[r] = \
                    c.signature
        for e in d.get("events", []):
            if e.get("phase") == "DESYNC":
                out.append(
                    f"rank {r} recorded DESYNC for "
                    f"{e.get('name', '?')!r} — submit-signature mismatch "
                    "caught at runtime")
    for (name, occ), by_rank in sigs.items():
        if len(set(by_rank.values())) > 1:
            out.append(
                f"signature mismatch for {name!r} (occurrence {occ}) "
                f"across ranks {sorted(by_rank)} — ranks submitted "
                "different collectives under one name")
    return out


# ===========================================================================
# Event-journal replay
# ===========================================================================

def check_journal(journal_dir) -> List[str]:
    """Divergences between a durable event journal and its protocol
    rules. Empty list = conformant. Three audits, sharing the carry-
    forward style of :func:`_audit_stream`:

    - per-writer, per-component ``seq`` strict monotonicity (the
      JournalSpec's durable-order invariant, checked on real artifacts);
    - epoch-claim monotonicity over each writer's stream — a journal
      record claiming an older ``control_epoch`` after a newer one was
      recorded means a fenced-out incarnation kept emitting;
    - generation regression per writer (same rule ``_audit_stream``
      applies to the ``_GENERATION_FAMILIES`` KV records).
    """
    from horovod_tpu_torch.common import journal as _journal
    out: List[str] = []
    files = _journal.segment_files(journal_dir)
    if not files:
        out.append(f"{journal_dir}: no journal_*.log segments — not a "
                   "journal directory")
        return out
    for writer, segments in sorted(files.items()):
        last_seq: Optional[int] = None
        max_epoch: Optional[int] = None
        max_gen: Optional[int] = None
        i = -1
        for seg in segments:
            for rec in _journal.iter_segment(seg):
                i += 1
                label = f"journal[{writer}][{i}]"
                seq = rec.get("seq")
                if not isinstance(seq, int):
                    out.append(f"{label}: missing/non-integer seq "
                               f"{seq!r}")
                elif last_seq is not None and seq <= last_seq:
                    out.append(
                        f"{label}: seq {seq} after {last_seq} — the "
                        "per-writer append order regressed (rotation "
                        "dropped an unflushed segment, or two "
                        "processes shared one writer id)")
                if isinstance(seq, int):
                    last_seq = seq if last_seq is None \
                        else max(last_seq, seq)
                e = rec.get("control_epoch")
                if isinstance(e, int):
                    if max_epoch is not None and e < max_epoch:
                        out.append(
                            f"{label}: event {rec.get('event')!r} "
                            f"claimed control epoch {e} after "
                            f"{max_epoch} — a fenced-out incarnation "
                            "kept emitting (split-brain)")
                    max_epoch = max(max_epoch or e, e)
                g = rec.get("generation")
                if isinstance(g, int):
                    if max_gen is not None and g < max_gen:
                        out.append(
                            f"{label}: event {rec.get('event')!r} "
                            f"carried generation {g} after {max_gen} — "
                            "generation regressed within one writer")
                    max_gen = max(max_gen or g, g)
    return out


# ===========================================================================
# Artifact-directory front door
# ===========================================================================

def kv_record_count(kv_dir) -> int:
    """Records a KV directory holds: the ops of every shard's WAL plus the
    keys of every shard's snapshot (what a replay has to go on)."""
    kv_dir = Path(kv_dir)
    n = 0
    for f in kv_dir.glob("wal*.log"):
        n += sum(1 for _ in iter_wal_ops(kv_dir, f.name))
    for f in kv_dir.glob("snapshot*.json"):
        n += len(load_snapshot_keys(kv_dir, f.name))
    return n


def journal_record_count(journal_dir) -> int:
    """Records of every writer's segments in a journal directory."""
    from horovod_tpu_torch.common import journal as _journal
    return sum(1 for segments in _journal.segment_files(journal_dir).values()
               for seg in segments for _ in _journal.iter_segment(seg))


def check_artifacts(path, kv_dir=None, flight_dir=None,
                    journal_dir=None) -> dict:
    """Replay every artifact found under ``path`` (or the explicit
    ``kv_dir``/``flight_dir``/``journal_dir`` overrides):
    ``{"checked": [...], "divergences": [...], "records": {...}}``;
    ``records`` is each checked artifact set's record count (WAL ops and
    snapshot keys, flight events, journal records), so that a caller can
    refuse an empty directory. A soak artifact
    directory usually holds the control-plane KV dir (wal.log), a set of
    flight_rank*.json, and a journal/ of journal_*.log segments."""
    path = Path(path)
    checked: List[str] = []
    divergences: List[str] = []
    records: Dict[str, int] = {}

    kv_candidates = [Path(kv_dir)] if kv_dir else [
        d for d in [path, path / "kv", *sorted(path.glob("**/"))]
        if (d / "wal.log").exists() or (d / "snapshot.json").exists()]
    seen = set()
    for d in kv_candidates:
        d = d.resolve()
        if d in seen:
            continue
        seen.add(d)
        checked.append(f"kv-wal: {d}")
        records[checked[-1]] = kv_record_count(d)
        divergences += [f"{d}: {line}" for line in check_kv_wal(d)]

    fdir = Path(flight_dir) if flight_dir else path
    dump_files = sorted(fdir.glob("**/flight_rank*.json"))
    by_dir: Dict[Path, Dict[int, dict]] = {}
    for f in dump_files:
        try:
            dump = json.loads(f.read_text())
        except (OSError, ValueError):
            divergences.append(f"{f}: unreadable flight dump")
            continue
        by_dir.setdefault(f.parent, {})[int(dump.get("rank", -1))] = dump
    for d, dumps in sorted(by_dir.items()):
        checked.append(f"flight: {d} (ranks {sorted(dumps)})")
        records[checked[-1]] = sum(len(dump.get("events", []))
                                   for dump in dumps.values())
        divergences += [f"{d}: {line}"
                        for line in check_flight_dumps(dumps)]

    journal_candidates = [Path(journal_dir)] if journal_dir else [
        d for d in [path, path / "journal", *sorted(path.glob("**/"))]
        if sorted(d.glob("journal_*.log"))]
    seen = set()
    for d in journal_candidates:
        d = d.resolve()
        if d in seen:
            continue
        seen.add(d)
        checked.append(f"journal: {d}")
        records[checked[-1]] = journal_record_count(d)
        divergences += [f"{d}: {line}" for line in check_journal(d)]

    if not checked:
        divergences.append(
            f"{path}: no wal.log/snapshot.json, flight_rank*.json, or "
            "journal_*.log artifacts found")
    return {"checked": checked, "divergences": divergences,
            "records": records}
