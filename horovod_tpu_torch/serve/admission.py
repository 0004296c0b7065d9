"""SLO-aware admission: priority classes + per-tenant token-bucket quotas.

Counterpart of ``horovod_tpu/serve/admission.py``, copied (host code).

The bounded admission queue (serve/batcher.py) is a blunt instrument: past
saturation it rejects whoever arrives next, premium traffic included. This
module is the graded version the autoscaler needs while a resize is in
flight — the fleet degrades *by class* instead of by arrival order:

- **priority classes** (``HOROVOD_SERVE_PRIORITY_CLASSES``, lowest first):
  each class may enter only while the admission queue is under its fill
  threshold. With classes ``c_0..c_{L-1}`` class ``c_l`` admits while
  ``queue_fill < (l+1)/L`` — so as pressure builds the lowest class is
  shed first and the queue's top slice stays reserved for the highest,
  which is only ever rejected by the bounded queue itself. A request
  names its class in the body (``"priority": "premium"``); an *unknown*
  name is treated as the lowest class (a typo must not accidentally gain
  priority), a *missing* one as the highest (unclassified traffic keeps
  the pre-classes behavior: shed only by the full queue).
- **per-tenant quotas**: a token bucket per ``"tenant"`` body field
  (rate ``HOROVOD_SERVE_TENANT_QPS``, burst ``HOROVOD_SERVE_TENANT_BURST``);
  an exhausted tenant gets a 429 with ``Retry-After`` telling it exactly
  when one token refills, before the request ever touches the queue.
  Tenant-less requests share no bucket (quotas off for them).

Both checks are *immediate* — the 429 carries ``retry_after_seconds`` and
the frontend surfaces it as a ``Retry-After`` header, so well-behaved
clients back off instead of hammering a saturated fleet. Decisions land in
the shared metrics registry (``hvd_serve_admit_total`` /
``hvd_serve_shed_total`` by class, ``hvd_serve_quota_shed_total``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, NamedTuple, Optional

from horovod_tpu_torch.common.env import env_float, env_str
from horovod_tpu_torch.metrics.registry import MetricsRegistry, get_registry


def parse_priority_classes(spec: Optional[str] = None) -> Dict[str, int]:
    """``{class_name: level}`` from a comma-separated spec, lowest
    priority first (``"batch,standard,premium"`` → batch=0 … premium=2).
    Empty segments are ignored; duplicates keep their first level."""
    if spec is None:
        spec = env_str("HOROVOD_SERVE_PRIORITY_CLASSES")
    out: Dict[str, int] = {}
    for name in (spec or "").split(","):
        name = name.strip()
        if name and name not in out:
            out[name] = len(out)
    if not out:
        out = {"standard": 0}
    return out


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/sec refill, ``burst`` cap.
    ``take()`` returns seconds until one token refills (0.0 = admitted)."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = time.monotonic()

    def refill(self, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now

    @property
    def full(self) -> bool:
        """At burst capacity — an idle tenant whose bucket carries no
        state worth keeping (a fresh bucket is indistinguishable)."""
        return self.tokens >= self.burst

    def take(self, now: Optional[float] = None) -> float:
        self.refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate if self.rate > 0 else 60.0


class AdmitResult(NamedTuple):
    ok: bool
    cls: str                     # resolved priority class
    reason: str                  # "" when admitted
    retry_after_seconds: float   # backoff hint for 429 responses


class AdmissionController:
    """Priority-class shedding + tenant quotas in front of the batcher.

    Thread contract: ``admit`` may be called from any number of frontend
    handler threads; the tenant-bucket map is the only mutable state.
    The map is bounded: past :attr:`MAX_TRACKED_TENANTS`, buckets back
    at burst capacity (idle tenants — a fresh bucket is
    indistinguishable) are evicted, so a client rotating tenant ids
    cannot grow the ingress hot path without bound."""

    MAX_TRACKED_TENANTS = 4096

    def __init__(self, classes: Optional[Dict[str, int]] = None,
                 tenant_qps: Optional[float] = None,
                 tenant_burst: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.classes = dict(classes) if classes is not None \
            else parse_priority_classes()
        self.tenant_qps = tenant_qps if tenant_qps is not None \
            else env_float("HOROVOD_SERVE_TENANT_QPS")
        self.tenant_burst = tenant_burst if tenant_burst is not None \
            else env_float("HOROVOD_SERVE_TENANT_BURST")
        self._levels = max(self.classes.values()) + 1
        self._lowest = min(self.classes, key=self.classes.get)
        self._highest = max(self.classes, key=self.classes.get)
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        reg = registry if registry is not None else get_registry()
        self._admitted = {c: reg.counter("hvd_serve_admit_total",
                                         **{"class": c})
                          for c in self.classes}
        self._shed = {c: reg.counter("hvd_serve_shed_total",
                                     **{"class": c})
                      for c in self.classes}
        self._quota_shed = reg.counter("hvd_serve_quota_shed_total")

    def resolve_class(self, body: dict) -> str:
        name = body.get("priority")
        if name is None:
            return self._highest
        return name if name in self.classes else self._lowest

    def fill_threshold(self, cls: str) -> float:
        """Queue-fill fraction at which ``cls`` starts being shed."""
        return (self.classes[cls] + 1) / self._levels

    def admit(self, body: dict, queue_fill: float) -> AdmitResult:
        """One admission verdict. ``queue_fill`` is the batcher's current
        queue occupancy fraction (pending / queue_depth)."""
        cls = self.resolve_class(body)
        tenant = body.get("tenant")
        if tenant is not None and self.tenant_qps > 0:
            with self._lock:
                bucket = self._buckets.get(str(tenant))
                if bucket is None:
                    if len(self._buckets) >= self.MAX_TRACKED_TENANTS:
                        self._evict_idle_locked()
                    bucket = self._buckets[str(tenant)] = TokenBucket(
                        self.tenant_qps, self.tenant_burst)
                wait = bucket.take()
            if wait > 0:
                self._quota_shed.inc()
                self._shed[cls].inc()
                return AdmitResult(
                    False, cls,
                    f"tenant {tenant} over quota "
                    f"({self.tenant_qps:g} req/s)", round(wait, 3))
        threshold = self.fill_threshold(cls)
        if queue_fill >= threshold:
            self._shed[cls].inc()
            # the backoff hint scales with how far past its threshold the
            # class is — deeper pressure, longer retry
            return AdmitResult(
                False, cls,
                f"class {cls} shed under queue pressure "
                f"(fill {queue_fill:.2f} >= {threshold:.2f})",
                round(0.5 + queue_fill, 3))
        self._admitted[cls].inc()
        return AdmitResult(True, cls, "", 0.0)

    def _evict_idle_locked(self):
        """Drop buckets back at burst capacity (refilled first, so only
        genuinely idle tenants go); recently-active tenants survive.
        Backstop for slow-refill configurations where nothing is full
        yet: drop oldest-inserted buckets down to the cap — a
        rotating-id client gets fresh-burst treatment either way."""
        now = time.monotonic()
        for tenant, bucket in list(self._buckets.items()):
            bucket.refill(now)
            if bucket.full:
                del self._buckets[tenant]
        while len(self._buckets) >= self.MAX_TRACKED_TENANTS:
            self._buckets.pop(next(iter(self._buckets)))

    def counters(self) -> dict:
        """Per-class admit/shed totals (tests + /stats)."""
        return {
            "admitted": {c: m.value for c, m in self._admitted.items()},
            "shed": {c: m.value for c, m in self._shed.items()},
            "quota_shed": self._quota_shed.value,
        }


def controller_from_env(
        registry: Optional[MetricsRegistry] = None) -> AdmissionController:
    """The env-configured controller serve workers install."""
    return AdmissionController(registry=registry)
