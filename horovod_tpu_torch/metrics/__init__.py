"""Runtime metrics of the port (counterpart of ``horovod_tpu/metrics``):
the process-local registry, and the snapshot readers that the serving
plane's ``GET /stats`` uses (``snapshot_value``, ``snapshot_histogram``,
``histogram_quantile``, copied from the reference's ``metrics/__init__.py``
:134-203)."""

from __future__ import annotations

from typing import Optional

from horovod_tpu_torch.metrics.registry import (  # noqa: F401
    DEFAULT_SIZE_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    HistogramValue,
    Metric,
    MetricsRegistry,
    get_registry,
)


def snapshot_value(snapshot: dict, name: str, **labels) -> Optional[float]:
    """Scalar value of a counter/gauge family in a ``/metrics.json``
    snapshot (summed over samples matching ``labels`` — the families
    ``hvd-top`` and the driver read carry one sample each). None when the
    family is absent or no sample matches."""
    total, found = 0.0, False
    want = {str(k): str(v) for k, v in labels.items()}
    for m in snapshot.get("metrics", []):
        if m.get("name") != name:
            continue
        for s in m.get("samples", []):
            if "value" not in s:
                continue  # histogram family under a scalar lookup
            got = s.get("labels", {})
            if all(got.get(k) == v for k, v in want.items()):
                total += float(s["value"])
                found = True
    return total if found else None


def snapshot_histogram(snapshot: dict, name: str, **labels) -> Optional[dict]:
    """Merged histogram of a family in a ``/metrics.json`` snapshot:
    ``{"bounds": [...], "counts": [...], "sum": s, "count": n}`` with
    per-bucket (non-cumulative) counts, summed over samples matching
    ``labels``. None when absent/empty. Samples must share bucket bounds
    (true for every family one process exports)."""
    want = {str(k): str(v) for k, v in labels.items()}
    merged: Optional[dict] = None
    for m in snapshot.get("metrics", []):
        if m.get("name") != name:
            continue
        for s in m.get("samples", []):
            if "counts" not in s:
                continue
            got = s.get("labels", {})
            if not all(got.get(k) == v for k, v in want.items()):
                continue
            if merged is None:
                merged = {"bounds": list(s["bounds"]),
                          "counts": list(s["counts"]),
                          "sum": float(s.get("sum", 0.0)),
                          "count": int(s.get("count", 0))}
            elif list(s["bounds"]) == merged["bounds"]:
                merged["counts"] = [a + b for a, b in
                                    zip(merged["counts"], s["counts"])]
                merged["sum"] += float(s.get("sum", 0.0))
                merged["count"] += int(s.get("count", 0))
    return merged if merged and merged["count"] else None


def histogram_quantile(hist: dict, q: float) -> Optional[float]:
    """Estimate the ``q``-quantile (0..1) of a merged histogram
    (:func:`snapshot_histogram` shape) by linear interpolation inside the
    landing bucket — the standard Prometheus ``histogram_quantile``
    estimate. The overflow bucket clamps to its lower bound (no upper edge
    to interpolate toward). None for an empty histogram."""
    if not hist or not hist.get("count"):
        return None
    bounds, counts = hist["bounds"], hist["counts"]
    target = q * hist["count"]
    cum = 0.0
    for i, c in enumerate(counts):
        if cum + c >= target and c > 0:
            lo = bounds[i - 1] if i > 0 else 0.0
            if i >= len(bounds):
                return float(bounds[-1]) if bounds else None
            hi = bounds[i]
            frac = (target - cum) / c
            return lo + (hi - lo) * frac
        cum += c
    return float(bounds[-1]) if bounds else None
