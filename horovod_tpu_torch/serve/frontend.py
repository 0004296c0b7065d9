"""Stdlib HTTP ingress for the serving plane.

Counterpart of ``horovod_tpu/serve/frontend.py``: ``ServeFrontend`` copied
(host code); :func:`main`, the port's ``hvd-serve``, boots the TP LM on
the card.

Same server pattern as the metrics exporter and the rendezvous KV
(daemonized ``ThreadingHTTPServer``, port 0 for tests). Two modes:

- **local** (``batcher=``): requests are admitted into this process's
  continuous batcher and the handler thread blocks on the request event
  until the serving loop completes it — this is what every serve *worker*
  runs;
- **routed** (``router=``): requests are forwarded to the least-loaded
  registered worker with the router's no-silent-loss retry — this is the
  cluster *ingress* in front of the elastic worker pool.

Routes::

    POST /v1/generate   {"tokens": [...] | "prompt": "text",
                         "max_new_tokens": N, "deadline_ms": D, "id": ...}
        -> 200 {"id", "status": "ok"|"expired"|"failed", "tokens", ...}
        -> 400 on a malformed body or a token id outside the vocabulary
        -> 429 on admission rejection (backpressure)
        -> 503 when no worker accepts (routed mode), or while draining or
           after the serving loop stopped for good (local mode)
    GET /healthz        {"status": "ok"|"draining"|"failed"}  (503 while
                        draining — load balancers stop sending before the
                        drain ends — and once the serving loop stopped)
    GET /stats          serving counters + p50/p99 snapshot

``"prompt"`` strings are byte-level tokenized (UTF-8 bytes), which keeps
the demo/example path dependency-free; real deployments submit token ids.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from horovod_tpu_torch.common import journal
from horovod_tpu_torch.metrics import histogram_quantile, snapshot_histogram, \
    snapshot_value
from horovod_tpu_torch.metrics.registry import MetricsRegistry, get_registry
from horovod_tpu_torch.obs.tracing import ADMISSION, get_tracer
from horovod_tpu_torch.serve.admission import AdmissionController
from horovod_tpu_torch.serve.batcher import (AdmissionRejected,
                                            ContinuousBatcher,
                                            InvalidRequest)
from horovod_tpu_torch.serve.router import (NoWorkersError, RequestRouter,
                                           post_json)

# extra grace past the request deadline before the handler gives up on the
# serving loop delivering the completion event (it expires the request at
# the next step boundary, which needs one in-flight step to pass)
_WAIT_SLACK_SEC = 30.0


def serving_stats(snapshot: dict) -> dict:
    """Serving health summary from a metrics registry snapshot (what
    ``GET /stats`` returns)."""
    lat = snapshot_histogram(snapshot, "hvd_serve_request_latency_seconds")
    occ = snapshot_histogram(snapshot, "hvd_serve_batch_occupancy")
    out = {
        "requests_ok": snapshot_value(snapshot, "hvd_serve_requests_total",
                                      status="ok") or 0,
        "requests_rejected": snapshot_value(
            snapshot, "hvd_serve_requests_total", status="rejected") or 0,
        "requests_expired": snapshot_value(
            snapshot, "hvd_serve_requests_total", status="expired") or 0,
        "requests_failed": snapshot_value(
            snapshot, "hvd_serve_requests_total", status="failed") or 0,
        "queue_depth": snapshot_value(snapshot, "hvd_serve_queue_depth"),
        "inflight": snapshot_value(snapshot, "hvd_serve_inflight"),
        "tokens_out": snapshot_value(snapshot, "hvd_serve_tokens_total")
        or 0,
        "decode_steps": snapshot_value(snapshot,
                                       "hvd_serve_decode_steps_total") or 0,
    }
    # serving fast path: block-paged KV cache + speculative decode health
    lookups = snapshot_value(snapshot, "hvd_serve_cache_lookups_total") or 0
    hits = snapshot_value(snapshot, "hvd_serve_cache_hits_total") or 0
    proposed = snapshot_value(snapshot,
                              "hvd_serve_spec_proposed_total") or 0
    accepted = snapshot_value(snapshot,
                              "hvd_serve_spec_accepted_total") or 0
    out["cache"] = {
        "pool_blocks": snapshot_value(snapshot,
                                      "hvd_serve_cache_pool_blocks"),
        "blocks_used": snapshot_value(snapshot,
                                      "hvd_serve_cache_blocks_used"),
        "shared_blocks": snapshot_value(snapshot,
                                        "hvd_serve_cache_shared_blocks"),
        "hit_pct": round(100.0 * hits / lookups, 1) if lookups else None,
        "reuse": snapshot_value(snapshot,
                                "hvd_serve_cache_reuse_total") or 0,
        "evictions": snapshot_value(snapshot,
                                    "hvd_serve_cache_evictions_total") or 0,
        "prefill_tokens_saved": snapshot_value(
            snapshot, "hvd_serve_cache_prefill_tokens_saved_total") or 0,
        "spec_accept_pct": round(100.0 * accepted / proposed, 1)
        if proposed else None,
    }
    out["batch_occupancy_mean"] = round(occ["sum"] / occ["count"], 3) \
        if occ else None
    for q, key in ((0.5, "latency_p50_ms"), (0.99, "latency_p99_ms")):
        v = histogram_quantile(lat, q) if lat else None
        out[key] = round(v * 1e3, 3) if v is not None else None
    return out


def _echo_trace(payload: dict, trace_id) -> dict:
    """Echo the trace id in EVERY response — 200s, 429s, 5xx — so a
    client can hand it back for correlation with the server-side spans."""
    if trace_id is not None:
        payload["trace_id"] = trace_id
    return payload


def tokenize(body: dict) -> list:
    """Token ids from a request body: ``tokens`` verbatim, else byte-level
    of ``prompt``."""
    if body.get("tokens") is not None:
        return [int(t) for t in body["tokens"]]
    return list(str(body.get("prompt", "")).encode())


class ServeFrontend:
    """Threaded ingress over a local batcher or a cluster router."""

    def __init__(self, batcher: Optional[ContinuousBatcher] = None,
                 router: Optional[RequestRouter] = None,
                 port: int = 0, addr: str = "0.0.0.0",
                 registry: Optional[MetricsRegistry] = None,
                 dispatch_timeout: float = 60.0,
                 admission: Optional[AdmissionController] = None):
        if (batcher is None) == (router is None):
            raise ValueError("pass exactly one of batcher= (local worker "
                             "mode) or router= (cluster ingress mode)")
        self.batcher = batcher
        self.router = router
        # SLO-aware admission (serve/admission.py): class shedding bites
        # in local mode (the queue lives here); quotas bite in both modes.
        self.admission = admission
        self.registry = registry if registry is not None else get_registry()
        self._dispatch_timeout = dispatch_timeout
        self._draining = threading.Event()
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # silence
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                retry_after = payload.get("retry_after_seconds")
                if code == 429 and retry_after:
                    # integer ceiling: Retry-After is whole seconds
                    self.send_header("Retry-After",
                                     str(max(1, int(retry_after + 0.999))))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    if frontend.batcher is not None and \
                            frontend.batcher.closed is not None:
                        self._reply(503, {"status": "failed",
                                          "error": frontend.batcher.closed})
                    elif frontend.draining:
                        self._reply(503, {"status": "draining"})
                    else:
                        self._reply(200, {"status": "ok"})
                elif path == "/trace.json":
                    # this process's span buffer — what a collector (or
                    # the routed-mode ingress) fetches to merge a
                    # request's worker-side spans into one timeline
                    self._reply(200, {"spans": get_tracer().spans()})
                elif path == "/stats":
                    stats = serving_stats(frontend.registry.snapshot())
                    if frontend.batcher is not None and \
                            frontend.batcher.cache is not None:
                        # live conservation check (pool == free + charged
                        # + resident shared) — what the chaos drill
                        # asserts on the survivor after a peer kill
                        stats["cache"]["pool_balanced"] = \
                            frontend.batcher.cache.balanced()
                    if frontend.admission is not None:
                        stats["admission"] = frontend.admission.counters()
                    if frontend.router is not None:
                        # ingress mode: surface discovery health so load
                        # balancers/operators can see the router is
                        # serving from a stale (driver-outage) table
                        stats["router"] = frontend.router.stale_info()
                    self._reply(200, stats)
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                if path != "/v1/generate":
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._reply(400, {"error": f"bad request body: {e}"})
                    return
                code, payload = frontend.handle_generate(body)
                self._reply(code, payload)

        self._httpd = ThreadingHTTPServer((addr, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServeFrontend":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="hvd-serve-frontend")
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def set_draining(self, draining: bool = True):
        """Flip the health state a load balancer keys on: /healthz returns
        503 while the worker finishes what it already accepted."""
        if draining:
            self._draining.set()
        else:
            self._draining.clear()

    # -- request handling (transport-free, test-drivable) --------------------

    def handle_generate(self, body: dict):
        """(status_code, payload) for one generate request."""
        if self.batcher is not None:
            return self._handle_local(body)
        return self._handle_routed(body)

    def _admission_check(self, body: dict, queue_fill: float):
        """None when admitted, else the 429 (code, payload) pair."""
        if self.admission is None:
            return None
        verdict = self.admission.admit(body, queue_fill)
        if verdict.ok:
            return None
        tid = body.get("trace")
        journal.emit("serve", "shed", reason=verdict.reason,
                     priority_class=verdict.cls,
                     queue_fill=round(queue_fill, 3),
                     trace_id=tid.get("id") if isinstance(tid, dict)
                     else None)
        return 429, {"error": verdict.reason, "status": "rejected",
                     "priority_class": verdict.cls,
                     "retry_after_seconds": verdict.retry_after_seconds}

    def _handle_local(self, body: dict):
        tracer = get_tracer()
        # adopt the ingress sampling decision when routed to us; make it
        # here when WE are the ingress (trace id minted once per request)
        tid = tracer.adopt_or_start(body)
        if self.batcher.closed is not None:
            return 503, _echo_trace(
                {"error": self.batcher.closed, "status": "failed"}, tid)
        if self.draining:
            return 503, _echo_trace(
                {"error": "worker draining", "status": "rejected"}, tid)
        try:
            tokens = tokenize(body)
        except (TypeError, ValueError) as e:
            return 400, _echo_trace(
                {"error": f"bad tokens: {e}", "status": "rejected"}, tid)
        with tracer.span(tid, ADMISSION, "frontend", mode="local"):
            shed = self._admission_check(
                body,
                self.batcher.pending() / max(self.batcher.queue_depth, 1))
            if shed is None:
                try:
                    req = self.batcher.submit(
                        tokens,
                        max_new_tokens=body.get("max_new_tokens"),
                        deadline_ms=body.get("deadline_ms"),
                        request_id=body.get("id"),
                        trace=tid)
                except InvalidRequest as e:
                    shed = 400, {"error": str(e), "status": "rejected"}
                except AdmissionRejected as e:
                    journal.emit("serve", "shed", reason=str(e),
                                 trace_id=tid)
                    shed = 429, {"error": str(e), "status": "rejected"}
        if shed is not None:
            code, payload = shed
            return code, _echo_trace(payload, tid)
        deadline_ms = body.get("deadline_ms")
        if deadline_ms is None:  # an explicit 0 means "already due",
            deadline_ms = self.batcher.default_deadline_ms  # not default
        if not req.wait(deadline_ms / 1e3 + _WAIT_SLACK_SEC):
            # the loop should have expired it long before this fires; a
            # hung executor must still not wedge the handler thread
            self.batcher.complete(req, "failed", "serving loop unresponsive")
            return 500, _echo_trace(req.result(), tid)
        code = {"ok": 200, "expired": 504, "failed": 500,
                "rejected": 429}.get(req.status, 500)
        return code, _echo_trace(req.result(), tid)

    def _handle_routed(self, body: dict):
        tracer = get_tracer()
        tid = tracer.adopt_or_start(body)
        rid = str(body.get("id") or id(body))
        # trace propagation: the worker adopts this id instead of making
        # its own sampling decision (one decision per request, at ingress)
        body = tracer.inject(dict(body, id=rid), tid)
        # ingress mode: the queue lives on the workers, so only quotas
        # bite here (fill 0.0); class shedding happens where the queue is
        with tracer.span(tid, ADMISSION, "frontend", mode="ingress"):
            shed = self._admission_check(body, 0.0)
        if shed is not None:
            code, payload = shed
            return code, _echo_trace(payload, tid)
        try:
            resp = self.router.submit(
                rid, body,
                lambda w, payload: post_json(
                    w.addr, w.port, "/v1/generate", payload,
                    timeout=self._dispatch_timeout))
        except NoWorkersError as e:
            return 503, _echo_trace(
                {"error": str(e), "status": "failed", "id": rid}, tid)
        code = {"ok": 200, "expired": 504, "failed": 500,
                "rejected": 429}.get(resp.get("status"), 200)
        return code, _echo_trace(resp, tid)


def main(argv=None) -> int:
    """``hvd-serve`` of the port (``python -m
    horovod_tpu_torch.serve.frontend``): boot a demo local serving worker,
    the tiny TP LM at the reference's ``hvd-serve`` size (vocab 256, hidden
    64, mlp 256, 2 layers) on this process's card with the int8 activation
    wire, and serve until interrupted. Launched as several processes, the
    model axis spans them all: the first serves HTTP and leads each step,
    the others follow its steps. Production deployments embed
    :class:`ServeFrontend` / :mod:`horovod_tpu_torch.serve.worker`
    instead."""
    import argparse
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.env import env_int, env_str
    from horovod_tpu_torch.parallel.mesh import MeshSpec
    from horovod_tpu_torch.serve.executor import ServingLoop, make_tp_lm_step

    parser = argparse.ArgumentParser(
        prog="hvd-serve", description="demo serving worker (tiny TP LM)")
    parser.add_argument("--port", type=int,
                        default=env_int("HOROVOD_SERVE_PORT", 0) or 0)
    parser.add_argument("--compression", default=None,
                        help="activation wire format: none | int8 "
                             "(default HOROVOD_SERVE_ACT_COMPRESSION)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:local_rank)")
    args = parser.parse_args(argv)
    compression = args.compression if args.compression is not None \
        else env_str("HOROVOD_SERVE_ACT_COMPRESSION")

    basics.init(device=args.device,
                mesh_spec=MeshSpec(data=1, model=env_int("HOROVOD_SIZE")))
    try:
        step_fn, info = make_tp_lm_step(compression=compression,
                                        device=args.device)
        if not step_fn.leader:
            step_fn.follow()
            return 0
        batcher = ContinuousBatcher(vocab=info["vocab"])
        loop = ServingLoop(step_fn, batcher).start()
        frontend = ServeFrontend(batcher=batcher, port=args.port).start()
        print(f"hvd-serve: listening on :{frontend.port} "
              f"(tp_world={info['tp_world']}, "
              f"compression={info['compression']})", flush=True)
        try:
            loop.join()  # returns when a step failure stops it for good
        except KeyboardInterrupt:
            pass
        finally:
            loop.drain(timeout=10.0)
            loop.stop()
            frontend.stop()
            step_fn.stop()
        if loop.fatal is not None:
            print(f"hvd-serve: {batcher.closed}", flush=True)
            return 1
    finally:
        basics.shutdown()
    return 0

if __name__ == "__main__":
    import sys
    sys.exit(main())
