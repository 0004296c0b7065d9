"""Durable structured event journal: every control-plane event, on disk.

Counterpart of ``horovod_tpu/common/journal.py``, copied: the same framing,
segment names, schema and replay, so the reference's ``hvd-doctor`` and
conformance replay read what the port writes. The port's emitters are the
serving plane (batcher, router, frontend) and the worker side of elastic
training (``runner/elastic/headless.py``, ``preempt.py``).

- **Framing**: ``[u32 len LE][u32 crc32 LE][json event]``, flushed per
  append (the KV WAL's framing). Replay stops at the first truncated or
  corrupt record, so a SIGKILLed writer costs at most its final, unflushed
  event.
- **Segments**: each writer process owns
  ``journal_<host>_<pid>.<nnnnnn>.log`` files under
  ``HOROVOD_JOURNAL_DIR``. A segment that would exceed
  ``HOROVOD_JOURNAL_SEGMENT_BYTES`` is closed and a new one opened; at
  most ``HOROVOD_JOURNAL_SEGMENTS`` are retained per writer. The oldest
  *closed* segments are deleted first and the active segment never is, so
  rotation can never drop an unflushed record.
- **Schema**: every event carries ``component`` (emitting subsystem),
  ``event`` (type), ``host``/``pid`` (writer identity), ``seq``
  (per-writer monotonic), ``t_mono``/``t_wall`` clocks, and optionally
  ``rank``, ``control_epoch``, ``generation``, ``trace_id``, ``step`` plus
  free-form detail fields. Event id = ``<host>:<pid>:<seq>``.
- **Zero-cost when off**: :func:`emit` returns early when
  ``HOROVOD_JOURNAL_DIR`` is unset, and never raises: journaling is
  observability, not control flow.
"""

from __future__ import annotations

import json
import logging
import os
import re
import socket
import threading
import time
import zlib
from pathlib import Path
from typing import Dict, Iterator, List, Optional

from horovod_tpu_torch.common.env import env_int, env_is_set, env_str

_logger = logging.getLogger("horovod_tpu_torch.common.journal")

# mirrors runner/http_kv.py's replay ceiling — one framing, one bound
_MAX_RECORD_BYTES = 64 << 20

_SEGMENT_RE = re.compile(
    r"^journal_(?P<writer>.+)\.(?P<idx>\d{6})\.log$")

# Optional well-known fields emit() lifts out of **fields for schema
# hygiene (everything else rides along as detail).
_TYPED_FIELDS = ("rank", "control_epoch", "generation", "trace_id", "step")


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9.-]", "-", name or "unknown")


class JournalWriter:
    """One process's append side of the journal (thread-safe).

    Created lazily by :func:`emit`; instantiate directly only in tests
    and benchmarks that want explicit control of the directory and
    rotation knobs."""

    def __init__(self, journal_dir, host: Optional[str] = None,
                 pid: Optional[int] = None,
                 segment_bytes: Optional[int] = None,
                 max_segments: Optional[int] = None):
        self.dir = Path(journal_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host = host if host is not None else (
            env_str("HOROVOD_HOSTNAME") if env_is_set("HOROVOD_HOSTNAME")
            else socket.gethostname())
        self.pid = int(pid if pid is not None else os.getpid())
        self.writer_id = f"{_sanitize(self.host)}_{self.pid}"
        self.segment_bytes = int(
            segment_bytes if segment_bytes is not None
            else env_int("HOROVOD_JOURNAL_SEGMENT_BYTES"))
        self.max_segments = max(1, int(
            max_segments if max_segments is not None
            else env_int("HOROVOD_JOURNAL_SEGMENTS")))
        self._lock = threading.Lock()
        self._seq = 0
        self._seg_idx = 0
        self._seg_size = 0
        self._f = None
        # a respawned process with the same writer id (pid reuse, or a
        # supervisor-restarted driver) must CONTINUE the stream, not
        # clobber it: next segment index, and seq resumed past the last
        # durable record so the auditor's per-writer monotonicity holds
        # across the restart
        existing = []
        for p in self.dir.glob(f"journal_{self.writer_id}.*.log"):
            m = _SEGMENT_RE.match(p.name)
            if m:
                existing.append((int(m.group("idx")), p))
                self._seg_idx = max(self._seg_idx, int(m.group("idx")) + 1)
        for _idx, p in sorted(existing, reverse=True):
            last = None
            for rec in iter_segment(p):
                last = rec
            if last is not None and isinstance(last.get("seq"), int):
                self._seq = max(self._seq, last["seq"])
                break
        self._open_segment()
        from horovod_tpu_torch.metrics.registry import get_registry
        reg = get_registry()
        self._c_events = reg.counter(
            "hvd_journal_events_total", "events appended to the journal")
        self._c_rotations = reg.counter(
            "hvd_journal_rotations_total", "journal segment rotations")

    # -- segment lifecycle ----------------------------------------------------

    def _seg_path(self, idx: int) -> Path:
        return self.dir / f"journal_{self.writer_id}.{idx:06d}.log"

    @property
    def active_path(self) -> Path:
        """The segment currently being appended to (never retained
        away)."""
        return self._seg_path(self._seg_idx)

    def _open_segment(self):
        self._f = open(self._seg_path(self._seg_idx), "ab")
        self._seg_size = self._f.tell()

    def _rotate_locked(self):
        # close-then-open: the outgoing segment is fully flushed before
        # it stops being the active one, so rotation never strands an
        # unflushed suffix (JournalSpec's rotation invariant)
        self._f.flush()
        self._f.close()
        self._seg_idx += 1
        self._open_segment()
        self._c_rotations.inc()
        # retention: delete oldest CLOSED segments beyond the cap; the
        # active segment (highest index) is structurally exempt
        segs = sorted(
            p for p in self.dir.glob(f"journal_{self.writer_id}.*.log")
            if _SEGMENT_RE.match(p.name))
        for p in segs[:max(0, len(segs) - self.max_segments)]:
            if p != self._seg_path(self._seg_idx):
                try:
                    p.unlink()
                except OSError:
                    pass

    # -- append ------------------------------------------------------------

    def append(self, component: str, event: str, **fields) -> dict:
        """Append one event; returns the full record (with its ``id``)."""
        with self._lock:
            self._seq += 1
            rec = {
                "id": f"{_sanitize(self.host)}:{self.pid}:{self._seq}",
                "seq": self._seq,
                "component": str(component),
                "event": str(event),
                "host": self.host,
                "pid": self.pid,
                "t_mono": time.monotonic(),
                "t_wall": time.time(),
            }
            for k in _TYPED_FIELDS:
                if k in fields and fields[k] is not None:
                    rec[k] = fields.pop(k)
            detail = {k: v for k, v in fields.items() if v is not None}
            if detail:
                rec["detail"] = detail
            payload = json.dumps(rec, default=str).encode()
            frame = (len(payload).to_bytes(4, "little") +
                     (zlib.crc32(payload) & 0xFFFFFFFF)
                     .to_bytes(4, "little") + payload)
            if self._seg_size and \
                    self._seg_size + len(frame) > self.segment_bytes:
                self._rotate_locked()
            self._f.write(frame)
            self._f.flush()
            self._seg_size += len(frame)
            self._c_events.inc()
            return rec

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None


# ===========================================================================
# Module-level emit (the one call sites use)
# ===========================================================================

_WRITER: Optional[JournalWriter] = None
_WRITER_DIR: Optional[str] = None
_WRITER_LOCK = threading.Lock()
_WARNED = False


def enabled() -> bool:
    """True when ``HOROVOD_JOURNAL_DIR`` is set (journaling active)."""
    return bool(env_str("HOROVOD_JOURNAL_DIR"))


def emit(component: str, event: str, **fields) -> Optional[dict]:
    """Journal one structured event. A cheap no-op (returns None) when
    ``HOROVOD_JOURNAL_DIR`` is unset; never raises — an unwritable
    journal degrades to a one-time warning, not a control-plane
    failure."""
    global _WRITER, _WRITER_DIR, _WARNED
    jdir = env_str("HOROVOD_JOURNAL_DIR")
    if not jdir:
        return None
    try:
        w = _WRITER
        if w is None or _WRITER_DIR != jdir:
            with _WRITER_LOCK:
                if _WRITER is None or _WRITER_DIR != jdir:
                    _WRITER = JournalWriter(jdir)
                    _WRITER_DIR = jdir
                w = _WRITER
        return w.append(component, event, **fields)
    except Exception as e:  # noqa: BLE001 — journaling must never raise
        if not _WARNED:
            _WARNED = True
            _logger.warning("event journal disabled after error: %r", e)
        return None


def _reset_for_tests():
    global _WRITER, _WRITER_DIR, _WARNED
    with _WRITER_LOCK:
        if _WRITER is not None:
            try:
                _WRITER.close()
            except Exception:  # noqa: BLE001
                pass
        _WRITER = None
        _WRITER_DIR = None
        _WARNED = False


# ===========================================================================
# Replay (read-only — never mutates the artifact)
# ===========================================================================

def iter_segment(path) -> Iterator[dict]:
    """Decode one segment file, stopping at the first truncated or
    corrupt record (the crash-tolerance contract shared with the KV
    WAL's replay)."""
    try:
        data = Path(path).read_bytes()
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
            rec = json.loads(payload)
        except ValueError:
            return
        if isinstance(rec, dict):
            yield rec
        off += 8 + length


def segment_files(journal_dir) -> Dict[str, List[Path]]:
    """``writer_id -> [segment paths in index order]`` for one journal
    directory."""
    by_writer: Dict[str, List[Path]] = {}
    try:
        names = sorted(Path(journal_dir).glob("journal_*.log"))
    except OSError:
        return {}
    for p in names:
        m = _SEGMENT_RE.match(p.name)
        if m:
            by_writer.setdefault(m.group("writer"), []).append(p)
    for segs in by_writer.values():
        segs.sort(key=lambda p: p.name)
    return by_writer


def iter_journal(journal_dir) -> Iterator[dict]:
    """Every event in a journal directory, writer by writer, each
    writer's stream in segment/seq order."""
    for _writer, segs in sorted(segment_files(journal_dir).items()):
        for seg in segs:
            yield from iter_segment(seg)


def load_events(journal_dir) -> List[dict]:
    """All events of a journal directory as a list (doctor's loader)."""
    return list(iter_journal(journal_dir))
