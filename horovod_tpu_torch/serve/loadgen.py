"""Open-loop load generation for the serving plane.

Counterpart of ``horovod_tpu/serve/loadgen.py``, copied (host code):
:func:`run_load` / :func:`run_points` offer load against any
``submit(payload) -> result`` callable (the local frontend handler, an
HTTP client, the router). Open-loop matters: a closed loop slows its own
arrival rate when the server saturates and can never show the
backpressure knee; here arrivals keep coming at the offered rate and the
rejected/expired counts + p99 show graceful degradation (bounded queue,
fast 429s) instead of collapse. :func:`shared_prefix_trace` is the seeded
shared-prefix request trace the fast path is measured on.

The reference's small-tensor latency microbench
(``small_allreduce_latency``, ``small_tensor_cliff_report``) measures the
C++ engine's serving-mode express lane, which the port's
``torch.distributed`` data plane does not have yet; it is ported with that
lane.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    if not values:
        return None
    xs = sorted(values)
    idx = min(int(q * len(xs)), len(xs) - 1)
    return xs[idx]


def run_load(submit: Callable[[dict], dict], offered_qps: float,
             duration_sec: float, make_payload: Callable[[int], dict],
             max_dispatchers: int = 32) -> Dict[str, object]:
    """Offer ``offered_qps`` for ``duration_sec`` against ``submit``.

    ``submit`` must be blocking and return a result dict with a
    ``status`` key (``ok``/``rejected``/``expired``/``failed``); raising
    counts as ``failed``. A fixed dispatcher pool drains the arrival
    schedule; when the pool can't keep up (server slower than offered
    load), arrivals back up client-side and the achieved rate drops —
    which is the saturation signal, reported honestly rather than by
    slowing the offered clock."""
    n = max(1, int(offered_qps * duration_sec))
    interval = 1.0 / offered_qps
    t0 = time.monotonic()
    schedule = [t0 + i * interval for i in range(n)]
    cursor = {"i": 0}
    lock = threading.Lock()
    latencies: List[float] = []
    counts = {"ok": 0, "rejected": 0, "expired": 0, "failed": 0}

    def dispatch():
        while True:
            with lock:
                i = cursor["i"]
                if i >= n:
                    return
                cursor["i"] = i + 1
                due = schedule[i]
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            start = time.monotonic()
            try:
                result = submit(make_payload(i))
                status = result.get("status", "failed")
            except Exception:  # noqa: BLE001 — a refused dispatch is a
                status = "failed"  # data point, not a bench crash
            took = time.monotonic() - start
            with lock:
                counts[status] = counts.get(status, 0) + 1
                if status == "ok":
                    latencies.append(took)

    workers = [threading.Thread(target=dispatch, daemon=True)
               for _ in range(min(max_dispatchers, n))]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    wall = time.monotonic() - t0
    # a submit that returned a non-terminal status (e.g. a client-side
    # wait timeout handing back "running") must not vanish from the
    # accounting: requests == ok + rejected + expired + failed + unsettled
    unsettled = sum(v for k, v in counts.items()
                    if k not in ("ok", "rejected", "expired", "failed"))
    return {
        "offered_qps": round(offered_qps, 2),
        "duration_sec": round(wall, 2),
        "requests": n,
        "completed_ok": counts["ok"],
        "rejected": counts["rejected"],
        "expired": counts["expired"],
        "failed": counts["failed"],
        "unsettled": unsettled,
        "achieved_qps": round(counts["ok"] / wall, 2) if wall > 0 else 0.0,
        "p50_ms": round(percentile(latencies, 0.50) * 1e3, 2)
        if latencies else None,
        "p99_ms": round(percentile(latencies, 0.99) * 1e3, 2)
        if latencies else None,
    }


def shared_prefix_trace(seed: int = 0, requests: int = 256,
                        tenants: int = 4, prefix_len: int = 96,
                        tail_len: int = 16, max_new_tokens: int = 16,
                        vocab: int = 256,
                        tenant_mix: Optional[Sequence[float]] = None
                        ) -> List[dict]:
    """Seeded, replayable shared-prefix request trace (the fast path's
    traffic in ``chip_smoke.py`` and the tests).

    Each tenant has one fixed ``prefix_len``-token system prompt; every
    request is that prefix plus a fresh ``tail_len``-token user turn.
    ``tenant_mix`` weights the tenant draw (default is zipf-ish: tenant 0
    dominates — the million-users-one-system-prompt shape where prefix
    reuse pays). Identical ``(seed, knobs)`` always reproduce the exact
    same token streams, so a bench regression is re-runnable bit-for-bit.
    """
    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(0, vocab, prefix_len).tolist()
                for _ in range(tenants)]
    mix = np.asarray(tenant_mix if tenant_mix is not None
                     else [1.0 / (i + 1) for i in range(tenants)], float)
    mix = mix / mix.sum()
    out: List[dict] = []
    for _ in range(requests):
        t = int(rng.choice(tenants, p=mix))
        tail = rng.randint(0, vocab, tail_len).tolist()
        out.append({"tenant": f"tenant{t}",
                    "tokens": prefixes[t] + tail,
                    "max_new_tokens": int(max_new_tokens)})
    return out


def trace_payload_fn(trace: Sequence[dict]) -> Callable[[int], dict]:
    """Adapter: a replayable trace as the ``make_payload`` argument of
    :func:`run_load` (wraps around when offered load outruns the trace)."""

    def make_payload(i: int) -> dict:
        return dict(trace[i % len(trace)])

    return make_payload


def run_points(submit: Callable[[dict], dict],
               make_payload: Callable[[int], dict],
               points_qps: Sequence[float],
               duration_sec: float = 3.0) -> List[Dict[str, object]]:
    """One :func:`run_load` window per offered-load point (a sweep
    should hold at least one point past saturation, so that it shows
    backpressure, not collapse)."""
    return [run_load(submit, qps, duration_sec, make_payload)
            for qps in points_qps]
