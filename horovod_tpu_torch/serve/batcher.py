"""Continuous-batching admission control and scheduling.

Counterpart of ``horovod_tpu/serve/batcher.py``, copied (host code); the
bucket plan reads the port's flash crossover.

The serving-side counterpart of the engine's fusion buffer: where training
batches *tensors* to amortize collective launch cost, serving batches
*requests* to amortize forward-pass launch cost — but under a latency
budget, so the scheduler is deadline- and occupancy-driven rather than
byte-driven:

- **bounded admission queue**: ``HOROVOD_SERVE_QUEUE_DEPTH`` requests may
  wait; a full queue rejects immediately (backpressure — the caller gets a
  429-shaped error *now* instead of a timeout later, and offered load past
  saturation degrades gracefully instead of collapsing);
- **per-request deadlines**: every request carries an absolute deadline
  (client-supplied or ``HOROVOD_SERVE_DEADLINE_MS``); queued requests whose
  deadline passes are expired without ever costing a forward pass, and
  running ones are expired at the next step boundary;
- **length buckets shared with the flash-attention router**: a request is
  padded to the smallest power-of-two bucket that fits prompt + budget, and
  a batch only ever contains one bucket — so each bucket compiles exactly
  one executable for its whole lifetime, and the bucket's attention kernel
  route (dense attention below ``HOROVOD_FLASH_MIN_SEQ``, flash at and
  above it) is a static property of the bucket, not a per-step surprise;
- **continuous (in-flight) batching**: finished requests free their slots
  at every decode-step boundary and queued same-bucket requests are
  admitted into them immediately — no drain-the-batch barrier.

All counters/histograms land in the process metrics registry
(``hvd_serve_*`` families), which ``GET /stats`` reads.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from horovod_tpu_torch.common import journal
from horovod_tpu_torch.common.env import env_float, env_int
from horovod_tpu_torch.metrics.registry import MetricsRegistry, get_registry
from horovod_tpu_torch.obs.tracing import QUEUE_WAIT, get_tracer, now_us

# Latency buckets for request-level histograms: serving targets live in the
# 1ms..10s decade.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)
# Occupancy buckets (requests per step).
OCCUPANCY_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

_TERMINAL = ("ok", "expired", "rejected", "failed")


class AdmissionRejected(RuntimeError):
    """The bounded admission queue is full (backpressure) or the request
    cannot fit any bucket; the caller should shed or retry elsewhere."""


class InvalidRequest(ValueError):
    """A request the model cannot take: a token id outside its vocabulary.
    The client's fault (HTTP 400), refused before anything reaches the
    device."""


def check_token_ids(tokens, vocab: int) -> None:
    """Raise :class:`InvalidRequest` unless every id in ``tokens`` lies in
    ``[0, vocab)``. On a CUDA device an embedding lookup past its table is
    a device-side assert, which leaves the process's CUDA context unusable
    for every later step; so ids are checked on the host."""
    ids = np.asarray(tokens).reshape(-1)
    if ids.size and (ids.min() < 0 or ids.max() >= vocab):
        bad = ids[(ids < 0) | (ids >= vocab)][0]
        raise InvalidRequest(f"token id {int(bad)} outside the vocabulary "
                             f"[0, {vocab})")


def default_buckets(max_len: int = 2048, min_bucket: int = 32) -> Tuple[int,
                                                                        ...]:
    """Power-of-two padded lengths from ``min_bucket`` through ``max_len``
    — the same geometric ladder the flash-attention block sizes assume, so
    bucketed batches tile the kernel grid exactly."""
    out = []
    b = min_bucket
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``length``; raises
    :class:`AdmissionRejected` when none does (the request could never
    complete within the configured context)."""
    for b in buckets:
        if length <= b:
            return b
    raise AdmissionRejected(
        f"request needs {length} tokens; largest bucket is {buckets[-1]}")


def bucket_plan(buckets: Optional[Sequence[int]] = None,
                max_len: int = 2048) -> List[dict]:
    """Static routing plan per bucket: which attention kernel the length
    router (:func:`horovod_tpu_torch.ops.flash_attention.attention`) picks
    for sequences padded to that bucket: ``"flash"`` from the port's
    crossover (``flash_min_seq``, 256 on the H100 unless
    ``HOROVOD_FLASH_MIN_SEQ`` says otherwise; the reference's is 1024),
    ``"dense"`` below it. Because a batch is single-bucket, this is decided
    once per bucket: serving never flips kernels mid-request."""
    from horovod_tpu_torch.ops.flash_attention import flash_min_seq
    crossover = flash_min_seq()
    return [{"bucket": b,
             "attention_kernel": "flash" if b >= crossover else "dense"}
            for b in (buckets or default_buckets(max_len))]


class InferenceRequest:
    """One admitted generation request.

    Completion is signalled through a per-request event; the HTTP frontend
    thread blocks on :meth:`wait` while the serving loop advances the
    request one token per step. Terminal states: ``ok`` (budget or EOS
    reached), ``expired`` (deadline passed — partial output is returned),
    ``failed`` (executor error).
    """

    __slots__ = ("id", "tokens", "max_new_tokens", "deadline", "arrival",
                 "bucket", "generated", "status", "error", "finished_at",
                 "lease", "trace", "_done")

    def __init__(self, tokens: Sequence[int], max_new_tokens: int,
                 deadline: float, bucket: int,
                 request_id: Optional[str] = None,
                 trace: Optional[str] = None):
        self.id = request_id or uuid.uuid4().hex[:16]
        self.tokens = [int(t) for t in tokens]
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = float(deadline)  # absolute time.monotonic()
        self.arrival = time.monotonic()
        self.bucket = int(bucket)
        self.generated: List[int] = []
        self.lease = None  # CacheLease when the batcher owns a KV cache
        self.trace = trace  # sampled trace id (None on the untraced
        # fast path — every per-stage span emission keys on this)
        self.status = "queued"
        self.error = ""
        self.finished_at: Optional[float] = None
        self._done = threading.Event()

    @property
    def length(self) -> int:
        """Current true (unpadded) sequence length."""
        return len(self.tokens) + len(self.generated)

    @property
    def done(self) -> bool:
        return self.status in _TERMINAL

    def finish(self, status: str, error: str = ""):
        if self.done:
            return
        self.status = status
        self.error = error
        self.finished_at = time.monotonic()
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self) -> dict:
        latency = (self.finished_at - self.arrival) \
            if self.finished_at is not None else None
        return {"id": self.id, "status": self.status,
                "tokens": list(self.generated),
                "error": self.error or None,
                "latency_ms": round(latency * 1e3, 3)
                if latency is not None else None}


class ContinuousBatcher:
    """Admission queue + slot scheduler for the serving loop.

    Thread contract: any number of producer threads call :meth:`submit`;
    exactly one consumer (the serving loop) calls :meth:`fill`,
    :meth:`observe_step` and :meth:`complete`.
    """

    def __init__(self, max_batch: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 max_len: int = 2048,
                 buckets: Optional[Sequence[int]] = None,
                 max_new_tokens_cap: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 cache=None, vocab: Optional[int] = None):
        self.max_batch = max_batch if max_batch is not None \
            else env_int("HOROVOD_SERVE_MAX_BATCH")
        self.queue_depth = queue_depth if queue_depth is not None \
            else env_int("HOROVOD_SERVE_QUEUE_DEPTH")
        self.default_deadline_ms = default_deadline_ms \
            if default_deadline_ms is not None \
            else env_float("HOROVOD_SERVE_DEADLINE_MS")
        self.max_new_tokens_cap = max_new_tokens_cap \
            if max_new_tokens_cap is not None \
            else env_int("HOROVOD_SERVE_MAX_NEW_TOKENS")
        self.buckets = tuple(buckets) if buckets is not None \
            else default_buckets(max_len)
        # optional block-paged KV cache (serve/kv_cache.py): when set,
        # admission charges blocks against its bounded pool and the
        # expiry split below (release vs free) keeps it balanced
        self.cache = cache
        # the model's vocabulary: submit() refuses ids outside it (None:
        # unchecked, for models that take any id, as the toy ones do)
        self.vocab = vocab
        self.closed: Optional[str] = None  # why the loop stopped for good
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        reg = registry if registry is not None else get_registry()
        self._requests = {s: reg.counter("hvd_serve_requests_total",
                                         status=s)
                          for s in _TERMINAL}
        self._admitted = reg.counter("hvd_serve_admitted_total")
        self._tokens_out = reg.counter("hvd_serve_tokens_total")
        self._depth = reg.gauge("hvd_serve_queue_depth")
        self._occupancy = reg.histogram("hvd_serve_batch_occupancy",
                                        buckets=OCCUPANCY_BUCKETS)
        self._latency = reg.histogram("hvd_serve_request_latency_seconds",
                                      buckets=LATENCY_BUCKETS)
        self._queue_wait = reg.histogram("hvd_serve_queue_wait_seconds",
                                         buckets=LATENCY_BUCKETS)

    # -- producer side -------------------------------------------------------

    def submit(self, tokens: Sequence[int],
               max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               request_id: Optional[str] = None,
               trace: Optional[str] = None) -> InferenceRequest:
        """Admit a request or raise :class:`AdmissionRejected`.

        Rejections are counted and *immediate* — backpressure is the
        defined behavior past saturation, never an unbounded queue. The
        bucket is fixed here (prompt + token budget), so a request's batch
        shape and kernel route never change mid-flight."""
        if self.vocab is not None:
            check_token_ids(tokens, self.vocab)
        budget = min(int(max_new_tokens) if max_new_tokens is not None
                     else self.max_new_tokens_cap, self.max_new_tokens_cap)
        budget = max(budget, 1)
        try:
            bucket = bucket_for(len(tokens) + budget, self.buckets)
        except AdmissionRejected:
            self._requests["rejected"].inc()
            raise
        ddl_ms = float(deadline_ms) if deadline_ms is not None \
            else self.default_deadline_ms
        req = InferenceRequest(tokens, budget,
                               time.monotonic() + ddl_ms / 1e3, bucket,
                               request_id=request_id, trace=trace)
        with self._lock:
            if self.closed is not None:
                self._requests["rejected"].inc()
                req.finish("rejected", self.closed)
                raise AdmissionRejected(self.closed)
            if len(self._queue) >= self.queue_depth:
                self._requests["rejected"].inc()
                req.finish("rejected", "admission queue full (backpressure)")
                raise AdmissionRejected(
                    f"admission queue full ({self.queue_depth} waiting)")
            if self.cache is not None:
                from horovod_tpu_torch.serve.kv_cache import CacheExhausted
                try:
                    # charge the block pool NOW: a request that cannot
                    # get cache blocks is a 429 at admission, never an
                    # OOM mid-decode
                    req.lease = self.cache.admit(req.tokens, budget,
                                                 trace=trace)
                except CacheExhausted as e:
                    self._requests["rejected"].inc()
                    req.finish("rejected", str(e))
                    raise AdmissionRejected(str(e)) from None
            self._queue.append(req)
            self._depth.set(len(self._queue))
            self._admitted.inc()
            self._work.notify()
        return req

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def close(self, reason: str) -> None:
        """The serving loop has stopped for good: fail everything queued
        and refuse every later submit with ``reason``."""
        with self._lock:
            self.closed = reason
            while self._queue:
                self._finish(self._queue.popleft(), "failed", reason)
            self._depth.set(0)
            self._work.notify_all()

    # -- consumer (serving loop) side ----------------------------------------

    def wait_for_work(self, timeout: float) -> bool:
        """Block until something is queued (or timeout); True when work
        exists."""
        with self._lock:
            if self._queue:
                return True
            self._work.wait(timeout)
            return bool(self._queue)

    def _expire_queued_locked(self, now: float):
        kept: deque = deque()
        while self._queue:
            req = self._queue.popleft()
            if req.deadline <= now:
                self._finish(req, "expired",
                             "deadline passed while queued")
            else:
                kept.append(req)
        self._queue = kept

    def fill(self, running: List[InferenceRequest]) -> List[InferenceRequest]:
        """One scheduling pass: expire stale queued requests, then admit
        queued requests into free slots. Single-bucket batches: the first
        admitted request pins the bucket; only same-bucket requests join
        (others keep their arrival order for the next batch — skipped, not
        reordered past each other)."""
        now = time.monotonic()
        out = [r for r in running if not r.done]
        with self._lock:
            self._expire_queued_locked(now)
            bucket = out[0].bucket if out else None
            if self._queue and bucket is None:
                bucket = self._queue[0].bucket
            skipped: List[InferenceRequest] = []
            while self._queue and len(out) < self.max_batch:
                req = self._queue.popleft()
                if req.bucket != bucket:
                    skipped.append(req)
                    continue
                req.status = "running"
                wait = now - req.arrival
                self._queue_wait.observe(wait)
                if req.trace is not None:
                    # span start back-dated to arrival: the wait is over
                    # by the time anyone can observe it
                    get_tracer().record(
                        req.trace, QUEUE_WAIT, "batcher",
                        now_us() - wait * 1e6, wait * 1e6,
                        bucket=req.bucket)
                out.append(req)
            for req in reversed(skipped):
                self._queue.appendleft(req)
            self._depth.set(len(self._queue))
        return out

    def observe_step(self, occupancy: int):
        if occupancy > 0:
            self._occupancy.observe(occupancy)

    def complete(self, req: InferenceRequest, status: str = "ok",
                 error: str = ""):
        self._finish(req, status, error)

    def _finish(self, req: InferenceRequest, status: str, error: str = ""):
        if req.done:
            return
        was_queued = req.status == "queued"
        if status in ("expired", "rejected"):
            journal.emit("serve", f"request_{status}", trace_id=req.trace,
                         request_id=req.id, error=error,
                         was_queued=was_queued)
        req.finish(status, error)
        if req.lease is not None and self.cache is not None:
            # the expiry split: a request that never left the queue only
            # ever held charged capacity (release — it provably never
            # bound a block); one that ran frees exactly what it charged
            # at the step boundary where its (partial) output returns
            if was_queued:
                self.cache.release(req.lease)
            else:
                self.cache.free(req.lease)
        self._requests[status].inc()
        if status == "ok":
            self._tokens_out.inc(len(req.generated))
        self._latency.observe(req.finished_at - req.arrival)
