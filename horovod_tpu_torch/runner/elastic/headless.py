"""Bounded worker autonomy under control-plane loss ("headless" mode).

Counterpart of ``horovod_tpu/runner/elastic/headless.py``: the same
transitions, log lines and event-journal records (``common/journal.py``:
``headless_entered``, ``headless_exited``, ``headless_abort``).

When the elastic driver (and the rendezvous KV it hosts) disappears, the
*data plane* between workers is untouched — training collectives keep
flowing peer-to-peer. Killing a healthy 64-rank job because its metadata
service restarted would be self-inflicted damage, so workers degrade
instead of dying:

    CONNECTED --KV write fails--> HEADLESS --KV write succeeds--> CONNECTED
                                     |
         sustained outage > HOROVOD_HEADLESS_DEADLINE_SECONDS --> abort

While HEADLESS:

- training continues (nothing here blocks the step path);
- control-plane writes that must not be lost (drain announcements, shard
  handoffs) are **queued** via :func:`queue_write` and replayed in order
  on reconnect;
- ``hvd_driver_unreachable_seconds`` tracks the outage for scrapes;
- only an outage longer than the deadline aborts (the driver is then
  presumed permanently gone and an unsupervised job would leak forever).

The worker KV heartbeat thread (:func:`runner.elastic.worker
.start_heartbeat`) is the probe that drives the transitions.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, List, Optional, Tuple

from horovod_tpu_torch.common import journal
from horovod_tpu_torch.common.env import env_float

UNREACHABLE_SECONDS = "hvd_driver_unreachable_seconds"

# queued control-plane writes are small JSON blobs; past this the oldest
# are dropped loudly (an unbounded queue during an hours-long outage is a
# memory leak wearing a durability costume)
_QUEUE_LIMIT = 1024

_logger = logging.getLogger("horovod_tpu_torch.elastic.headless")
_lock = threading.Lock()
_outage_start: Optional[float] = None
_queue: List[Tuple[str, dict]] = []
_abort_hook: Optional[Callable[[float], None]] = None


def _default_abort(outage_seconds: float):
    _logger.error(
        "headless deadline exceeded: %s",
        json.dumps({"event": "headless_deadline_exceeded",
                    "outage_seconds": round(outage_seconds, 1)}))
    journal.emit("worker", "headless_abort",
                 outage_seconds=round(outage_seconds, 1))
    os._exit(75)  # EX_TEMPFAIL: the control plane never came back


def set_abort_hook(hook: Optional[Callable[[float], None]]):
    """Override the deadline action (tests; schedulers that prefer a
    checkpoint-and-exit over a hard abort)."""
    global _abort_hook
    with _lock:
        _abort_hook = hook


def _gauge():
    from horovod_tpu_torch.metrics.registry import get_registry
    return get_registry().gauge(
        UNREACHABLE_SECONDS,
        "seconds the driver/KV has been unreachable (0 = connected)")


def is_headless() -> bool:
    with _lock:
        return _outage_start is not None


def unreachable_seconds() -> float:
    with _lock:
        if _outage_start is None:
            return 0.0
        return time.monotonic() - _outage_start


def queue_write(key: str, value: dict):
    """Defer a control-plane write until the driver returns. Order is
    preserved; overflow drops the oldest entry loudly."""
    with _lock:
        _queue.append((key, value))
        dropped = len(_queue) - _QUEUE_LIMIT
        if dropped > 0:
            del _queue[:dropped]
    if dropped > 0:
        _logger.warning("headless write queue overflow: dropped %d "
                        "oldest deferred write(s)", dropped)


def pending_writes() -> int:
    with _lock:
        return len(_queue)


def note_failure():
    """One failed KV probe: enter (or extend) the outage. Called by the
    heartbeat thread; transitions and the deadline check live here so the
    probe site stays one line."""
    global _outage_start
    with _lock:
        if _outage_start is None:
            _outage_start = time.monotonic()
            entered = True
        else:
            entered = False
        outage = time.monotonic() - _outage_start
        hook = _abort_hook
    try:
        _gauge().set(outage)
    except Exception:  # noqa: BLE001 — metrics must not break the probe
        pass
    if entered:
        _logger.warning(
            "driver unreachable: %s",
            json.dumps({"event": "headless_entered"}))
        journal.emit("worker", "headless_entered")
    deadline = env_float("HOROVOD_HEADLESS_DEADLINE_SECONDS")
    if deadline and deadline > 0 and outage > deadline:
        (hook or _default_abort)(outage)


def note_success(client=None):
    """One successful KV probe: leave headless mode and replay the
    deferred writes in order. ``client`` is the KVClient to replay
    through (omit to skip replay — e.g. probes that cannot write)."""
    global _outage_start
    with _lock:
        was = _outage_start
        _outage_start = None
        pending = list(_queue) if client is not None else []
        if client is not None:
            _queue.clear()
    try:
        _gauge().set(0.0)
    except Exception:  # noqa: BLE001
        pass
    if was is not None:
        journal.emit("worker", "headless_exited",
                     outage_seconds=round(time.monotonic() - was, 1),
                     replaying_writes=len(pending))
        _logger.warning(
            "driver reachable again: %s",
            json.dumps({"event": "headless_exited",
                        "outage_seconds":
                            round(time.monotonic() - was, 1),
                        "replaying_writes": len(pending)}))
    for i, (key, value) in enumerate(pending):
        try:
            client.put_json(key, value, attempts=1, deadline=2.0)
        except Exception as e:  # noqa: BLE001 — KV flapped again: requeue
            _logger.warning("deferred write replay failed (%r); "
                            "requeueing", e)
            with _lock:
                _queue[:0] = pending[i:]  # current + unreplayed tail
            note_failure()
            return


def _reset_for_tests():
    global _outage_start, _abort_hook
    with _lock:
        _outage_start = None
        _queue.clear()
        _abort_hook = None
