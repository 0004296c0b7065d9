"""Request routing over the elastic worker registry.

Counterpart of ``horovod_tpu/serve/router.py``, copied (host code);
``refresh_from_kv`` takes the port's ``runner/http_kv.py`` client's
``get_json``.

The router is the traffic-direction half of the serving plane: it holds the
live worker table (fed from the elastic rendezvous KV, where serve workers
publish their HTTP endpoints and the driver aggregates them into the
``serve_targets`` key each heartbeat), places each request on the
least-loaded accepting worker, and enforces the serving plane's central
durability contract:

    **an accepted request is never silently lost.**

Concretely:

- a worker absent from a new generation is *drained* — no new placements,
  in-flight requests get ``HOROVOD_SERVE_DRAIN_TIMEOUT_SECONDS`` to finish
  on the departing worker before the router re-routes them;
- a worker that *dies* (connection refused / reset mid-request) is marked
  dead immediately and the failed dispatch is retried on a surviving
  worker, up to ``HOROVOD_SERVE_RETRY_LIMIT`` times; only an exhausted
  retry budget surfaces an error to the caller (loud, counted in
  ``hvd_serve_lost_total`` — which a healthy cluster keeps at zero);
- generation changes (elastic resize) swap the worker table atomically:
  re-registered workers keep serving, new ones join the rotation, departed
  ones drain.

Transport is pluggable: :meth:`RequestRouter.submit` takes a ``send``
callable, so tests drive routing with in-process functions and production
uses :func:`post_json` against worker frontends.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional
from urllib import error as urlerror
from urllib import request as urlrequest

from horovod_tpu_torch.common import journal
from horovod_tpu_torch.common.env import env_int
from horovod_tpu_torch.metrics.registry import MetricsRegistry, get_registry
from horovod_tpu_torch.obs.tracing import RE_ROUTE, get_tracer, now_us

UP = "up"
DRAINING = "draining"
DEAD = "dead"


class NoWorkersError(RuntimeError):
    """No accepting worker is registered (all dead/draining or none yet)."""


def post_json(addr: str, port: int, path: str, payload: dict,
              timeout: float = 30.0) -> dict:
    """POST a JSON body, return the decoded JSON response.

    Only *transport* failures raise (connection refused/reset, timeout —
    the router's he's-dead retry path). An HTTP error status means the
    worker answered — a 429 is backpressure from a live worker, not a
    death — so its JSON body is returned like any other response and the
    ``status`` field carries the verdict."""
    body = json.dumps(payload).encode()
    req = urlrequest.Request(f"http://{addr}:{port}{path}", data=body,
                             method="POST",
                             headers={"Content-Type": "application/json"})
    try:
        with urlrequest.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urlerror.HTTPError as e:
        return json.loads(e.read())


class WorkerHandle:
    """One registered serving worker as the router sees it."""

    __slots__ = ("id", "addr", "port", "rank", "generation", "state",
                 "inflight")

    def __init__(self, id: str, addr: str, port: int, rank: Optional[int],
                 generation: int):
        self.id = id
        self.addr = addr
        self.port = int(port)
        self.rank = rank
        self.generation = generation
        self.state = UP
        self.inflight: set = set()

    @property
    def accepting(self) -> bool:
        return self.state == UP

    def describe(self) -> dict:
        return {"id": self.id, "addr": self.addr, "port": self.port,
                "rank": self.rank, "generation": self.generation,
                "state": self.state, "inflight": len(self.inflight)}


class RequestRouter:
    def __init__(self, retry_limit: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.retry_limit = retry_limit if retry_limit is not None \
            else env_int("HOROVOD_SERVE_RETRY_LIMIT")
        self._lock = threading.Lock()
        self._workers: Dict[str, WorkerHandle] = {}
        self.generation = -1
        # control-plane outage state: when discovery (the driver's
        # serve_targets key) disappears, the router keeps serving from
        # this last-known table, marked stale, instead of draining a
        # fleet of healthy workers over a dead metadata service
        self.discovery_stale = False
        self._last_refresh: Optional[float] = None  # monotonic
        self._log = logging.getLogger("horovod_tpu_torch.serve.router")
        reg = registry if registry is not None else get_registry()
        self._routed = reg.counter("hvd_serve_routed_total")
        self._rerouted = reg.counter("hvd_serve_rerouted_total")
        self._lost = reg.counter("hvd_serve_lost_total")
        self._workers_up = reg.gauge("hvd_serve_workers_up")

    # -- registry maintenance -----------------------------------------------

    def update_workers(self, entries: List[dict], generation: int):
        """Install the worker set of ``generation``. Entries:
        ``{"id", "addr", "port", "rank"?, "draining"?}``. Workers absent
        from the new set begin draining (their in-flight requests finish
        or get re-routed by their own dispatch threads); dead ones stay
        dead. An entry flagged ``draining`` (the driver's scale-down
        announce) stops taking NEW placements *immediately* — before,
        placement only reacted once the worker left the table, so every
        refresh-to-removal window placed fresh requests onto a worker
        already told to die."""
        with self._lock:
            seen = set()
            for e in entries:
                wid = str(e.get("id") or f"{e['addr']}:{e['port']}")
                # `or` would coerce an explicit generation 0 to the table
                # generation and revive a gen-0 corpse from its own stale
                # record — only a MISSING field inherits the table's
                eg = e.get("generation")
                entry_gen = int(eg) if eg is not None else int(generation)
                seen.add(wid)
                w = self._workers.get(wid)
                if w is None:
                    self._workers[wid] = w = WorkerHandle(
                        wid, e["addr"], e["port"], e.get("rank"),
                        entry_gen)
                else:
                    w.addr, w.port = e["addr"], int(e["port"])
                    w.rank = e.get("rank", w.rank)
                    if w.state == DRAINING and not e.get("draining"):
                        # re-registered without the flag: it stayed (a
                        # still-flagged entry keeps draining without a
                        # churny DRAINING->UP->DRAINING flip per refresh)
                        w.state = UP
                    elif w.state == DEAD and entry_gen > w.generation:
                        # a respawned slot reuses its id: only a STRICTLY
                        # newer registration revives it — the dead
                        # worker's stale KV record (same generation)
                        # must not resurrect a corpse into the rotation
                        w.state = UP
                        w.inflight.clear()
                    w.generation = max(w.generation, entry_gen)
                if e.get("draining") and w.state == UP:
                    w.state = DRAINING
                    self._log.info(
                        "worker %s announced draining (scale-down): no "
                        "new placements (%d in flight)", wid,
                        len(w.inflight))
            for wid_, w_ in list(self._workers.items()):
                if wid_ not in seen:
                    if w_.state == UP:
                        w_.state = DRAINING
                        self._log.info(
                            "worker %s absent from generation %d: draining "
                            "(%d in flight)", wid_, generation,
                            len(w_.inflight))
                    if not w_.inflight and w_.state == DRAINING:
                        del self._workers[wid_]
            self.generation = generation
            self._refresh_gauge_locked()

    def refresh_from_kv(self, kv_get_json: Callable[[str], Optional[dict]]
                        ) -> bool:
        """Pull the driver-published ``serve_targets`` key (same pattern as
        ``hvd-top``'s ``metrics_targets``) and install it. ``kv_get_json``
        is any ``key -> dict|None`` getter (KVServer.get_json,
        KVClient.get_json).

        Returns True on a successful refresh. A discovery outage (KV
        unreachable, key gone) keeps the last-known table and flips
        :attr:`discovery_stale` — surfaced in ``/stats`` — rather than
        draining workers that are still answering requests."""
        try:
            from horovod_tpu_torch.common import kv_keys
            info = kv_get_json(kv_keys.serve_targets())
        except Exception:  # noqa: BLE001 — KV mid-restart is an outage,
            info = None  # not a router crash
        if not isinstance(info, dict) or "workers" not in info:
            # "stale" means a previously-working discovery went away; a
            # router that has never refreshed (driver still publishing
            # its first table) is merely warming up, not degraded
            if self._last_refresh is not None:
                if not self.discovery_stale:
                    self._log.warning(
                        "serve discovery unreachable: %s",
                        json.dumps({"event": "discovery_stale",
                                    "workers": len(self._workers),
                                    "generation": self.generation}))
                    journal.emit("serve", "discovery_stale",
                                 generation=self.generation,
                                 workers=len(self._workers))
                self.discovery_stale = True
            return False
        self.update_workers(info["workers"],
                            int(info.get("generation", 0)))
        if self.discovery_stale:
            self._log.info("serve discovery recovered (generation %d)",
                           self.generation)
            journal.emit("serve", "discovery_recovered",
                         generation=self.generation,
                         workers=len(self._workers))
        self.discovery_stale = False
        self._last_refresh = time.monotonic()
        return True

    @property
    def discovery_age_seconds(self) -> Optional[float]:
        """Seconds since the last successful discovery refresh (None
        before the first one)."""
        if self._last_refresh is None:
            return None
        return time.monotonic() - self._last_refresh

    def stale_info(self) -> dict:
        """Discovery-health summary for ``/stats`` consumers."""
        age = self.discovery_age_seconds
        return {"discovery_stale": self.discovery_stale,
                "discovery_age_seconds":
                    round(age, 3) if age is not None else None,
                "generation": self.generation,
                "workers": len(self._workers)}

    def fail_worker(self, worker_id: str) -> List[str]:
        """Mark a worker dead; returns the request ids that were in flight
        on it (each owning dispatch thread re-routes its own)."""
        with self._lock:
            w = self._workers.get(worker_id)
            if w is None:
                return []
            w.state = DEAD
            orphans = list(w.inflight)
            w.inflight.clear()
            self._refresh_gauge_locked()
        if orphans:
            self._log.warning("worker %s died with %d request(s) in "
                              "flight; re-routing", worker_id, len(orphans))
        journal.emit("serve", "worker_failed", generation=self.generation,
                     worker=worker_id, orphans=len(orphans))
        return orphans

    def drain_worker(self, worker_id: str) -> List[str]:
        """Administrative drain: stop new placements, report in-flight."""
        with self._lock:
            w = self._workers.get(worker_id)
            if w is None:
                return []
            if w.state == UP:
                w.state = DRAINING
            self._refresh_gauge_locked()
            return list(w.inflight)

    def workers(self) -> List[dict]:
        with self._lock:
            return [w.describe() for w in self._workers.values()]

    def _refresh_gauge_locked(self):
        self._workers_up.set(
            sum(1 for w in self._workers.values() if w.accepting))

    # -- placement -----------------------------------------------------------

    def pick(self, exclude: Optional[set] = None) -> WorkerHandle:
        """Least-loaded accepting worker (ties by id for determinism)."""
        with self._lock:
            candidates = [w for w in self._workers.values()
                          if w.accepting and
                          (not exclude or w.id not in exclude)]
            if not candidates:
                raise NoWorkersError(
                    "no accepting serving worker registered")
            return min(candidates, key=lambda w: (len(w.inflight), w.id))

    def assign(self, worker: WorkerHandle, request_id: str):
        with self._lock:
            worker.inflight.add(request_id)

    def complete(self, worker: WorkerHandle, request_id: str):
        with self._lock:
            worker.inflight.discard(request_id)
            if worker.state == DRAINING and not worker.inflight:
                self._workers.pop(worker.id, None)
                self._log.info("worker %s fully drained", worker.id)

    def submit(self, request_id: str, payload: dict,
               send: Callable[[WorkerHandle, dict], dict]) -> dict:
        """Dispatch with the no-silent-loss contract: pick → send; a
        transport failure marks the worker dead and retries on a survivor
        (``hvd_serve_rerouted_total``), up to ``retry_limit`` extra
        attempts. Exhaustion raises — counted in ``hvd_serve_lost_total``,
        which a healthy cluster pins at zero."""
        last: Optional[Exception] = None
        tried: set = set()
        trace = payload.get("trace")
        tid = trace.get("id") if isinstance(trace, dict) else trace or None
        for attempt in range(self.retry_limit + 1):
            try:
                worker = self.pick(exclude=tried)
            except NoWorkersError:
                # every known worker already failed this request — widen
                # back out in case a replacement registered meanwhile
                try:
                    worker = self.pick()
                except NoWorkersError:
                    break
            self.assign(worker, request_id)
            t0 = now_us()
            try:
                resp = send(worker, payload)
            except Exception as e:  # noqa: BLE001 — transport failure is
                # the retry path, not a crash
                last = e
                tried.add(worker.id)
                self.fail_worker(worker.id)
                if attempt < self.retry_limit:
                    self._rerouted.inc()
                    journal.emit("serve", "re_route", trace_id=tid,
                                 request_id=request_id,
                                 failed_worker=worker.id, attempt=attempt)
                    # span covers the failed dispatch attempt — the time
                    # the re-route decision cost this request
                    get_tracer().record(
                        tid, RE_ROUTE, "router", t0, now_us() - t0,
                        failed_worker=worker.id, attempt=attempt,
                        error=repr(e))
                continue
            self.complete(worker, request_id)
            self._routed.inc()
            return resp
        self._lost.inc()
        raise NoWorkersError(
            f"request {request_id} failed after {self.retry_limit + 1} "
            f"attempt(s): {last!r}")
