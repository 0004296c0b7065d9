"""Distributed request tracing for the serving plane.

Counterpart of ``horovod_tpu/obs/tracing.py``, copied. A *sampled* trace
id is minted at frontend ingress (``HOROVOD_TRACE_SAMPLE``, default 0.0,
off), flows through router -> worker -> batcher -> kv_cache -> executor in
the request payload's ``"trace"`` field, and every stage emits a
Chrome-trace complete ("X") span into a bounded in-process ring buffer.
Export goes through ``profiler/trace_merge.py``, so one Perfetto-loadable
file shows a request's admission, queue wait, cache lookup, prefill,
draft/verify and decode steps.

Span inventory (``tid`` is the component lane)::

    admission     frontend   quota/class shedding + batcher submit
    queue_wait    batcher    arrival -> first scheduling into a batch
    cache_lookup  kv_cache   prefix-hash lookup + pool charge at admit
    prefill       executor   prompt consumption (first cached advance)
    draft         executor   draft-model proposal micro-steps
    verify        executor   target verification of drafted tokens
    decode_step   executor   one steady-state decode step
    re_route      router     dispatch retry after a worker death

Sampling rules: the decision is made once, at ingress; downstream stages
*adopt* an inbound trace id and never re-sample (a request is either fully
traced or not at all). Unsampled requests take a single-pointer fast path
(``req.trace is None``). The trace id is echoed as ``trace_id`` in every
HTTP response, 429 rejections included.

The buffer is a bounded deque (``HOROVOD_TRACE_BUFFER_SPANS``): old spans
fall off the back.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from collections import deque
from typing import List, Optional

from horovod_tpu_torch.common.env import env_float, env_int, env_str

# Span kinds (Chrome-trace event names).
ADMISSION = "admission"
QUEUE_WAIT = "queue_wait"
CACHE_LOOKUP = "cache_lookup"
PREFILL = "prefill"
DRAFT = "draft"
VERIFY = "verify"
DECODE_STEP = "decode_step"
RE_ROUTE = "re_route"

SPAN_KINDS = (ADMISSION, QUEUE_WAIT, CACHE_LOOKUP, PREFILL, DRAFT,
              VERIFY, DECODE_STEP, RE_ROUTE)


def now_us() -> float:
    """Wall-clock microseconds. Spans from different processes share the
    epoch timebase, so a merged cross-process timeline is aligned to NTP
    accuracy."""
    return time.time() * 1e6


class _Span:
    """Context manager that records one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_trace_id", "kind", "lane", "args", "_t0",
                 "_w0")

    def __init__(self, tracer: "Tracer", trace_id: str, kind: str,
                 lane: str, args: dict):
        self._tracer = tracer
        self._trace_id = trace_id
        self.kind = kind
        self.lane = lane
        self.args = args

    def __enter__(self) -> "_Span":
        self._w0 = now_us()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = (time.perf_counter() - self._t0) * 1e6
        if exc is not None:
            self.args = dict(self.args, error=repr(exc))
        self._tracer.record(self._trace_id, self.kind, self.lane,
                            self._w0, dur, **self.args)
        return False


class _NullSpan:
    """The unsampled fast path: enter/exit are attribute loads only."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Bounded span buffer + sampling decision for one process."""

    def __init__(self, sample: Optional[float] = None,
                 buffer_spans: Optional[int] = None):
        self.sample = sample if sample is not None \
            else env_float("HOROVOD_TRACE_SAMPLE")
        cap = buffer_spans if buffer_spans is not None \
            else env_int("HOROVOD_TRACE_BUFFER_SPANS")
        self._spans: deque = deque(maxlen=max(1, int(cap)))
        self._lock = threading.Lock()
        self._rng = random.Random()

    # -- sampling / propagation ---------------------------------------------

    def maybe_trace(self) -> Optional[str]:
        """The ingress sampling decision: a fresh trace id with
        probability ``sample``, else None (request untraced)."""
        if self.sample <= 0.0 or self._rng.random() >= self.sample:
            return None
        return uuid.uuid4().hex[:16]

    def adopt_or_start(self, body: dict) -> Optional[str]:
        """Trace id for one inbound request body: adopt the upstream
        decision when the payload carries one (worker behind an ingress
        router — never re-sample), else make the ingress decision."""
        trace = body.get("trace")
        if isinstance(trace, dict) and trace.get("id"):
            return str(trace["id"])
        if isinstance(trace, str) and trace:
            return trace
        return self.maybe_trace()

    @staticmethod
    def inject(body: dict, trace_id: Optional[str]) -> dict:
        """Propagate a trace id into an outbound request payload."""
        if trace_id is None:
            return body
        return dict(body, trace={"id": trace_id})

    # -- span emission -------------------------------------------------------

    def span(self, trace_id: Optional[str], kind: str, lane: str, **args):
        """Context manager emitting one span; free no-op when untraced."""
        if trace_id is None:
            return _NULL_SPAN
        return _Span(self, trace_id, kind, lane, args)

    def record(self, trace_id: Optional[str], kind: str, lane: str,
               ts_us: float, dur_us: float, **args):
        """Append one complete span (explicit timestamps — for spans
        whose start predates the call site, e.g. queue_wait)."""
        if trace_id is None:
            return
        event = {"name": kind, "ph": "X", "ts": float(ts_us),
                 "dur": max(0.0, float(dur_us)), "tid": lane,
                 "args": dict(args, trace=trace_id)}
        with self._lock:
            self._spans.append(event)

    # -- collection / export -------------------------------------------------

    def spans(self, trace_id: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [e for e in out
                   if e.get("args", {}).get("trace") == trace_id]
        return out

    def clear(self):
        with self._lock:
            self._spans.clear()

    def export(self, out_path=None, trace_id: Optional[str] = None,
               extra_spans: Optional[List[dict]] = None,
               label: str = "horovod serving") -> dict:
        """One Perfetto-loadable trace through ``merge_traces``.

        ``extra_spans`` lets a collector fold in spans fetched from OTHER
        processes (e.g. a worker's ``GET /trace.json``) so the frontend
        and executor halves of a routed request land in one timeline.
        Default ``out_path`` lands under ``HOROVOD_TRACE_DIR`` when set.
        """
        from horovod_tpu_torch.profiler.trace_merge import merge_traces
        events = self.spans(trace_id) + [
            e for e in (extra_spans or [])
            if trace_id is None or e.get("args", {}).get("trace") == trace_id]
        if out_path is None:
            trace_dir = env_str("HOROVOD_TRACE_DIR")
            if trace_dir:
                import os
                os.makedirs(trace_dir, exist_ok=True)
                out_path = os.path.join(
                    trace_dir, f"trace_{trace_id or 'all'}.json")
        return merge_traces(events, out_path=out_path, engine_label=label)


_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer (lazy, env-configured — the
    ``get_registry`` pattern)."""
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


def configure(sample: Optional[float] = None,
              buffer_spans: Optional[int] = None) -> Tracer:
    """Replace the global tracer (tests; runtime re-configuration)."""
    global _tracer
    with _tracer_lock:
        _tracer = Tracer(sample=sample, buffer_spans=buffer_spans)
    return _tracer
