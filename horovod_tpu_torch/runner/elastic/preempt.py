"""Preemption-notice draining for elastic workers.

Counterpart of ``horovod_tpu/runner/elastic/preempt.py``, with its
event-journal records (``common/journal.py``: ``drain_announce``,
``drain_finalize``). The shard handoff is encoded with the
port's numpy block-int8 codec (``parallel/zero.py``), byte for byte the
reference's.

Spot/preemptible pools deliver an eviction warning (SIGTERM, typically
30-120s before the machine dies). Without a drain path that warning is
wasted: the kill looks like a crash, the survivors fast-abort, the host is
charged a failure, and under ZeRO-1 the dead rank's optimizer-state shard
is simply gone. The drain protocol turns the warning into a clean resize:

1. the signal handler marks the worker ``draining`` and announces it on
   the rendezvous KV (``drain/<host>/<slot>``) — the driver sees the
   announcement on its next heartbeat and schedules a proactive rebalance
   that excludes the doomed slot (no blacklist, no abort storm);
2. the in-flight training step finishes normally — the drain only takes
   effect at the next ``State.commit()`` boundary, where live state is
   self-consistent;
3. the worker hands off its live ZeRO shard to the KV
   (``shard_handoff/w<world>/<rank>``, int8-compressed when
   ``HOROVOD_RESHARD_COMPRESSION=int8``) so the post-resize
   ``ShardedState.sync()`` resumes with ZERO state loss;
4. the worker records ``DRAINED`` in the worker-state registry and exits
   0 — ``ElasticDriver._reap_workers`` treats any exit of an announced
   drain as clean departure.

Everything here is best-effort by design: a preempted machine may die
mid-handoff, in which case the resize falls back to the ring-buddy replica
(see elastic.ShardedState) or fresh moments for that slice.
"""

from __future__ import annotations

import base64
import logging
import signal
import threading
import time
from typing import Optional

from horovod_tpu_torch.common import journal
from horovod_tpu_torch.common.env import env_bool, env_str

_logger = logging.getLogger("horovod_tpu_torch.elastic.preempt")

_lock = threading.Lock()
_installed = False
_requested = threading.Event()
_drained = threading.Event()


def drain_key(host: str, slot) -> str:
    """KV key a worker announces its departure under — shared single
    definition with the driver's heartbeat scan (typed registry:
    common/kv_keys.py)."""
    from horovod_tpu_torch.common import kv_keys
    return kv_keys.drain(host, slot)


def handoff_key(world: int, old_rank: int) -> str:
    """KV key for a departing rank's live shard payload, scoped by the
    shard layout's world size (the consuming sync knows the old world from
    the survivor descriptors, not the drain generation)."""
    from horovod_tpu_torch.common import kv_keys
    return kv_keys.shard_handoff(world, old_rank)


def preempt_requested() -> bool:
    """True once a preemption notice has been received (the worker should
    drain at the next commit boundary)."""
    return _requested.is_set()


def request_preemption():
    """Mark this worker as preempted and announce the drain on the KV.

    Called by the signal handler, but also directly by tests and by
    schedulers that learn about eviction through an API rather than a
    signal."""
    if _requested.is_set():
        return
    _requested.set()
    # The KV announcement leaves the signal context immediately: HTTP from
    # a handler risks re-entrancy, and the put must retry.
    threading.Thread(target=_announce, daemon=True).start()


def _on_preempt_signal(*_):
    # A REPEATED notice forces immediate exit: the first one starts the
    # graceful drain, but the sender (the platform's grace-expired kill,
    # or the elastic driver's own teardown killpg) must still be able to
    # stop a worker that never reaches a commit boundary.
    if _requested.is_set():
        import os
        os._exit(143)
    request_preemption()


def _announce():
    from horovod_tpu_torch.runner.elastic import worker as elastic_worker
    if not elastic_worker.is_elastic_worker():
        return
    host, slot = elastic_worker._slot()
    payload = {
        "generation": elastic_worker.current_generation(),
        "ts": time.time(),
    }
    try:
        elastic_worker.kv_client().put_json(drain_key(host, slot), payload,
                                            deadline=10.0)
        _logger.warning("preemption notice: announced drain for %s/%s",
                        host, slot)
        journal.emit("worker", "drain_announce",
                     generation=payload["generation"], host=host,
                     local_rank=slot)
    except Exception as e:  # noqa: BLE001 — the driver also sees the exit
        # headless mode (driver mid-restart): queue the announcement so
        # the heartbeat thread replays it the moment the KV returns
        from horovod_tpu_torch.runner.elastic import headless
        headless.queue_write(drain_key(host, slot), payload)
        _logger.warning("drain announcement failed (%r); queued for "
                        "replay on driver reconnect", e)


def install_preempt_handler(sig: Optional[str] = None) -> bool:
    """Install the preemption-notice handler (idempotent; main thread
    only — signal.signal raises elsewhere, in which case the caller polls
    ``request_preemption`` through other means). Returns True when
    installed."""
    global _installed
    with _lock:
        if _installed:
            return True
        name = sig or env_str("HOROVOD_PREEMPT_SIGNAL")
        signum = getattr(signal, name, None)
        if signum is None:
            _logger.warning("unknown HOROVOD_PREEMPT_SIGNAL %r", name)
            return False
        try:
            signal.signal(signum, _on_preempt_signal)
        except ValueError:  # not the main thread
            return False
        _installed = True
        return True


def _reset_for_tests():
    global _installed
    with _lock:
        _installed = False
        _requested.clear()
        _drained.clear()


# -- shard handoff (step 3) -------------------------------------------------


def encode_shard_stacks(stacks: dict, quantized: bool = False) -> dict:
    """JSON-safe encoding of ``{name: {group: [rows, shard] array}}`` —
    the KV transports base64 blobs. With ``quantized`` float payloads ride
    the block-int8 codec (scales + values), ~4x smaller on the wire."""
    import numpy as np
    from horovod_tpu_torch.parallel import zero
    out = {}
    for name, groups in stacks.items():
        enc = {}
        for key, arr in groups.items():
            arr = np.asarray(arr)
            entry = {"dtype": str(arr.dtype), "rows": int(arr.shape[0]),
                     "cols": int(arr.shape[1])}
            if quantized and arr.dtype.kind == "f":
                q, scales = zero.quantize_blocks_np(arr.ravel())
                entry["codec"] = "int8"
                entry["b64"] = base64.b64encode(q.tobytes()).decode()
                entry["scales_b64"] = base64.b64encode(
                    scales.tobytes()).decode()
            else:
                entry["codec"] = "raw"
                entry["b64"] = base64.b64encode(
                    np.ascontiguousarray(arr).tobytes()).decode()
            enc[key] = entry
        out[name] = enc
    return out


def decode_shard_stacks(payload: dict) -> dict:
    import numpy as np
    from horovod_tpu_torch.parallel import zero
    out = {}
    for name, groups in payload.items():
        dec = {}
        for key, entry in groups.items():
            dtype = np.dtype(entry["dtype"])
            rows, cols = int(entry["rows"]), int(entry["cols"])
            raw = base64.b64decode(entry["b64"])
            if entry.get("codec") == "int8":
                q = np.frombuffer(raw, np.int8)
                scales = np.frombuffer(
                    base64.b64decode(entry["scales_b64"]), np.float32)
                flat = zero.dequantize_blocks_np(q, scales, dtype)
            else:
                flat = np.frombuffer(raw, dtype)
            dec[key] = flat.reshape(rows, cols).copy()
        out[name] = dec
    return out


def publish_handoff(world: int, old_rank: int, stacks: dict,
                    client=None) -> bool:
    """Publish a departing rank's live shard stacks to the KV. Returns
    False (without raising) when the handoff could not land — the resize
    then falls back to buddy replicas."""
    if not env_bool("HOROVOD_PREEMPT_HANDOFF"):
        return False
    from horovod_tpu_torch.runner.elastic import worker as elastic_worker
    quantized = env_str("HOROVOD_RESHARD_COMPRESSION") == "int8"
    payload = {
        "world": int(world),
        "old_rank": int(old_rank),
        "quantized": quantized,
        "ts": time.time(),
        "stacks": encode_shard_stacks(stacks, quantized),
    }
    try:
        (client or elastic_worker.kv_client()).put_json(
            handoff_key(world, old_rank), payload, deadline=20.0)
        return True
    except Exception as e:  # noqa: BLE001 — machine may die any moment
        # best-effort replay if the process survives until the KV is
        # back; the caller still treats this handoff as not-landed (the
        # resize falls back to the buddy replica, and fetch_handoff's
        # TTL rejects a too-late replay)
        from horovod_tpu_torch.runner.elastic import headless
        headless.queue_write(handoff_key(world, old_rank), payload)
        _logger.warning("shard handoff failed (%r); queued for replay", e)
        return False


def fetch_handoff(world: int, old_rank: int, client=None) -> Optional[dict]:
    """The decoded ``{name: {group: [rows, shard]}}`` stacks a drained
    rank left behind, or None.

    Stale payloads are rejected: a handoff is only meaningful for the
    resize that immediately follows its drain — an hours-old key (e.g.
    one a scale-to-one consumer failed to GC) must not outrank a fresh
    buddy replica in the source-assignment preference."""
    from horovod_tpu_torch.common.env import env_float
    from horovod_tpu_torch.runner.elastic import worker as elastic_worker
    try:
        # Short deadline, not the KV's rendezvous-style 5s poll: a
        # handoff either landed before the resize began (the drain
        # published it before exiting) or it never will (hard kill) —
        # and every missing rank's probe holds ALL peers inside the
        # offers collective, so long 404 polling here multiplies
        # straight into recovery time.
        payload = (client or elastic_worker.kv_client()).get_json(
            handoff_key(world, old_rank), timeout=1.0, poll_interval=0.4)
    except Exception:  # noqa: BLE001 — KV may be restarting
        return None
    if not isinstance(payload, dict) or "stacks" not in payload:
        return None
    ttl = env_float("HOROVOD_PREEMPT_COOLDOWN_SECONDS")
    if ttl <= 0:
        ttl = 600.0
    if time.time() - float(payload.get("ts", 0)) > ttl:
        return None
    return decode_shard_stacks(payload["stacks"])


def finalize_drain(state=None):
    """Complete the drain at a safe (commit) boundary: hand off the live
    shard, record DRAINED, exit cleanly. Raises SystemExit(0)."""
    from horovod_tpu_torch.runner.elastic import worker as elastic_worker
    if _drained.is_set():
        raise SystemExit(0)
    _drained.set()
    if elastic_worker.is_elastic_worker():
        payload_fn = getattr(state, "shard_handoff_payload", None)
        if callable(payload_fn):
            try:
                world, old_rank, data = payload_fn()
                if data:
                    publish_handoff(world, old_rank, data)
            except Exception as e:  # noqa: BLE001 — best effort
                _logger.warning("handoff skipped: %r", e)
        try:
            elastic_worker.record_state(
                elastic_worker.current_generation(),
                elastic_worker.DRAINED)
        except Exception:  # noqa: BLE001 — the exit code still says clean
            pass
    _logger.warning("drain complete; exiting cleanly")
    journal.emit("worker", "drain_finalize")
    raise SystemExit(0)
