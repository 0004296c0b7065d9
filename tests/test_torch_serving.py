"""The port's serving plane on the CPU, case for case the reference's
tests/test_serving.py against horovod_tpu_torch.serve: continuous batching,
deadlines and backpressure, the serving loop, routing with drain-on-death,
the HTTP frontend, the serve worker's drain, and the fast path (paged
cache, prefix reuse, speculative decode). Beyond them: the bucket plan on
the port's flash crossover, the router fed by the port's KV client, the
worker's KV registration and its entry point as a process, the heartbeat
allreduce failing as HorovodInternalError when a peer dies, ``hvd-serve``
of the port, and the speculative-decode pin on the port's recurrent LM.
The engine's express lane and the driver-spawned serve fleet wait for
their modules (the engine's serving mode, the launcher).

Every HTTP server binds port 0 and each test that counts metrics uses its
own MetricsRegistry.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from urllib import error as urlerror

import numpy as np
import pytest

from horovod_tpu_torch.metrics.registry import MetricsRegistry
from horovod_tpu_torch.serve.batcher import (AdmissionRejected,
                                             ContinuousBatcher,
                                             InvalidRequest, bucket_for,
                                             bucket_plan, default_buckets)
from horovod_tpu_torch.serve.executor import ServingLoop, make_toy_step
from horovod_tpu_torch.serve.frontend import ServeFrontend, serving_stats
from horovod_tpu_torch.serve.router import NoWorkersError, RequestRouter

import torch_dist_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stack(step_fn=None, **kw):
    """Fresh batcher + serving loop on an isolated registry."""
    reg = MetricsRegistry()
    kw.setdefault("max_batch", 4)
    kw.setdefault("queue_depth", 8)
    kw.setdefault("default_deadline_ms", 2000.0)
    kw.setdefault("max_len", 128)
    batcher = ContinuousBatcher(registry=reg, **kw)
    loop = ServingLoop(step_fn or make_toy_step(), batcher, registry=reg)
    return reg, batcher, loop


def _toy_reference(tokens, n_new, vocab=256):
    """The toy model's expected greedy continuation."""
    seq = list(tokens)
    out = []
    for _ in range(n_new):
        nxt = (sum(seq) + len(seq)) % vocab
        out.append(nxt)
        seq.append(nxt)
    return out


# ---------------------------------------------------------------------------
# bucketing


def test_default_buckets_and_bucket_for():
    buckets = default_buckets(max_len=256, min_bucket=32)
    assert buckets == (32, 64, 128, 256)
    assert bucket_for(1, buckets) == 32
    assert bucket_for(32, buckets) == 32
    assert bucket_for(33, buckets) == 64
    assert bucket_for(256, buckets) == 256
    with pytest.raises(AdmissionRejected):
        bucket_for(257, buckets)


@pytest.mark.parametrize("env,dense", [(None, (32, 64, 128)),
                                       ("128", (32, 64)),
                                       ("1024", (32, 64, 128, 256))])
def test_bucket_plan_follows_the_port_crossover(monkeypatch, env, dense):
    """The per-bucket attention route is the port's length router: flash
    from its crossover (256 on the H100, HOROVOD_FLASH_MIN_SEQ when set),
    dense below. The reference plans on its own crossover (1024 on a TPU)
    and calls the dense route "xla": at the default the two plans differ
    by design, with the same env value they agree on every route."""
    from horovod_tpu.serve.batcher import bucket_plan as ref_plan
    if env is None:
        monkeypatch.delenv("HOROVOD_FLASH_MIN_SEQ", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_FLASH_MIN_SEQ", env)
    buckets = default_buckets(256, 32)
    plan = {p["bucket"]: p["attention_kernel"] for p in bucket_plan(buckets)}
    assert plan == {b: "dense" if b in dense else "flash" for b in buckets}
    ref = {p["bucket"]: p["attention_kernel"] for p in ref_plan(buckets)}
    same = {b: {"xla": "dense"}.get(k, k) for b, k in ref.items()} == plan
    assert same == (env is not None)


# ---------------------------------------------------------------------------
# batcher: deadlines, backpressure, scheduling


def test_queued_deadline_expires_without_execution():
    reg, batcher, _ = _stack()  # no loop running: requests sit queued
    req = batcher.submit([1, 2, 3], max_new_tokens=4, deadline_ms=10.0)
    time.sleep(0.05)
    assert batcher.fill([]) == []  # expired at scheduling time, never admitted
    assert req.status == "expired"
    assert req.generated == []
    from horovod_tpu_torch.metrics import snapshot_value
    assert snapshot_value(reg.snapshot(), "hvd_serve_requests_total",
                          status="expired") == 1


def test_backpressure_rejects_when_queue_full():
    reg, batcher, _ = _stack(queue_depth=3)
    for i in range(3):
        batcher.submit([i], max_new_tokens=1)
    with pytest.raises(AdmissionRejected):
        batcher.submit([99], max_new_tokens=1)
    from horovod_tpu_torch.metrics import snapshot_value
    snap = reg.snapshot()
    assert snapshot_value(snap, "hvd_serve_requests_total",
                          status="rejected") == 1
    assert snapshot_value(snap, "hvd_serve_queue_depth") == 3


def test_explicit_zero_budget_is_not_the_default_cap():
    """max_new_tokens=0 is a tiny request (floored to 1 token), NOT a
    fall-through to the 32-token default cap (falsy-zero regression)."""
    _, batcher, _ = _stack()
    req = batcher.submit([1, 2, 3], max_new_tokens=0)
    assert req.max_new_tokens == 1


def test_single_bucket_batches():
    """fill() never mixes buckets: a 32-bucket and a 128-bucket request
    are scheduled in separate batches, in arrival order per bucket."""
    _, batcher, _ = _stack(max_len=128)
    small = batcher.submit([1] * 4, max_new_tokens=4)        # bucket 32
    big = batcher.submit([1] * 100, max_new_tokens=4)        # bucket 128
    small2 = batcher.submit([2] * 5, max_new_tokens=4)       # bucket 32
    batch1 = batcher.fill([])
    assert {r.id for r in batch1} == {small.id, small2.id}
    for r in batch1:
        batcher.complete(r, "ok")
    batch2 = batcher.fill([])
    assert [r.id for r in batch2] == [big.id]


def test_decode_completes_and_matches_toy_reference():
    _, batcher, loop = _stack()
    loop.start()
    try:
        reqs = [batcher.submit([i, i + 1, i + 2], max_new_tokens=5)
                for i in range(3)]
        for r in reqs:
            assert r.wait(10.0), r.status
            assert r.status == "ok"
        for i, r in enumerate(reqs):
            assert r.generated == _toy_reference([i, i + 1, i + 2], 5)
    finally:
        loop.stop()


def test_continuous_batching_admits_into_inflight_batch():
    """A request submitted while a batch is mid-generation joins it at a
    step boundary (occupancy reaches 2) instead of waiting for a drain."""
    reg, batcher, _ = _stack()
    step_base = make_toy_step()

    def slow_step(tokens, lengths):
        time.sleep(0.02)
        return step_base(tokens, lengths)

    loop = ServingLoop(slow_step, batcher, registry=reg).start()
    try:
        first = batcher.submit([1, 2], max_new_tokens=30)
        time.sleep(0.06)  # a few steps in flight
        second = batcher.submit([3, 4], max_new_tokens=2)
        assert second.wait(10.0) and second.status == "ok"
        assert not first.done  # joined and finished while first still ran
        assert first.wait(10.0) and first.status == "ok"
        from horovod_tpu_torch.metrics import snapshot_histogram
        occ = snapshot_histogram(reg.snapshot(), "hvd_serve_batch_occupancy")
        # some steps carried both requests (occupancy bucket > 1)
        assert sum(occ["counts"][1:]) > 0, occ
    finally:
        loop.stop()


def test_mid_generation_deadline_returns_partial():
    _, batcher, _ = _stack()
    step_base = make_toy_step()

    def slow_step(tokens, lengths):
        time.sleep(0.03)
        return step_base(tokens, lengths)

    reg2 = MetricsRegistry()
    loop = ServingLoop(slow_step, batcher, registry=reg2).start()
    try:
        req = batcher.submit([5, 6], max_new_tokens=64, deadline_ms=120.0)
        assert req.wait(10.0)
        assert req.status == "expired"
        assert 0 < len(req.generated) < 64  # partial output, not dropped
    finally:
        loop.stop()


def test_serving_loop_executor_failure_fails_requests_loudly():
    reg, batcher, _ = _stack()

    def broken_step(tokens, lengths):
        raise RuntimeError("kaboom")

    loop = ServingLoop(broken_step, batcher, registry=reg).start()
    try:
        req = batcher.submit([1], max_new_tokens=2)
        assert req.wait(10.0)
        assert req.status == "failed"
        assert "kaboom" in req.error
    finally:
        loop.stop()


def test_serving_loop_stops_for_good_on_a_group_fatal_step():
    """A step failing with HorovodInternalError (its group out of step)
    ends the loop: the batch it carried and everything queued fail, the
    loop's thread ends with ``fatal`` set, later submits are refused, and
    the frontend answers 503 on /healthz and /v1/generate."""
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    reg, batcher, _ = _stack(max_batch=2)

    def broken_step(tokens, lengths):
        raise HorovodInternalError("group out of step")

    reqs = [batcher.submit([1], max_new_tokens=2) for _ in range(4)]
    loop = ServingLoop(broken_step, batcher, registry=reg).start()
    fe = ServeFrontend(batcher=batcher, port=0, addr="127.0.0.1",
                       registry=reg).start()
    base = f"http://127.0.0.1:{fe.port}"
    try:
        for r in reqs:
            assert r.wait(10.0)
        assert [r.status for r in reqs] == ["failed"] * 4
        assert "group out of step" in reqs[0].error
        assert "serving loop stopped" in reqs[3].error
        assert loop.join(10.0)
        assert isinstance(loop.fatal, HorovodInternalError)
        with pytest.raises(AdmissionRejected, match="serving loop stopped"):
            batcher.submit([1])
        code, health = _http(base + "/healthz")
        assert code == 503 and health["status"] == "failed"
        code, out = _http(base + "/v1/generate", {"tokens": [1]})
        assert code == 503 and out["status"] == "failed"
    finally:
        fe.stop()
        loop.stop()


def _small_tp_step(**kw):
    from horovod_tpu_torch.serve.executor import make_tp_lm_step
    return make_tp_lm_step(device="cpu", axis=None, compression="int8",
                           **dict(cases.SERVE_TP_DIMS, **kw))[0]


@pytest.mark.parametrize("model", ["tp", "rnn"])
@pytest.mark.parametrize("bad", [64, -1, 1000])
def test_steps_refuse_ids_outside_the_vocabulary(model, bad):
    """Both models check token ids on the host before anything reaches
    the device (on a card an embedding lookup past its table is a
    device-side assert that leaves the CUDA context unusable), and serve
    valid ids after refusing."""
    from horovod_tpu_torch.serve.executor import make_rnn_lm_step
    tokens = np.zeros((2, 8), np.int32)
    tokens[1, :3] = [1, bad, 2]
    lengths = np.array([1, 3], np.int32)
    if model == "tp":
        step = _small_tp_step()
        with pytest.raises(InvalidRequest, match=f"token id {bad} "):
            step(tokens, lengths)
        tokens[1, 1] = 5
        assert step(tokens, lengths).shape == (2,)
    else:
        _, cached, _, _ = make_rnn_lm_step(hidden=16, vocab=64,
                                           device="cpu")
        state = cached.init_state(2)
        start = np.zeros(2, np.int64)
        with pytest.raises(InvalidRequest, match=f"token id {bad} "):
            cached.advance(tokens, lengths.astype(np.int64), state, start)
        tokens[1, 1] = 5
        preds, _ = cached.advance(tokens, lengths.astype(np.int64), state,
                                  start)
        assert preds.shape == (2, 3)


def test_frontend_refuses_ids_outside_the_vocabulary():
    """With the model's vocabulary on the batcher, ids outside it (or not
    ids at all) are answered 400 before admission; the worker stays
    healthy and the next valid request comes back ok, with the tokens of
    its prompt decoded alone."""
    step = _small_tp_step()
    vocab = cases.SERVE_TP_DIMS["vocab"]
    reg, batcher, _ = _stack(max_batch=8, vocab=vocab)
    loop = ServingLoop(step, batcher, registry=reg).start()
    fe = ServeFrontend(batcher=batcher, port=0, addr="127.0.0.1",
                       registry=reg).start()
    base = f"http://127.0.0.1:{fe.port}"
    try:
        for tokens in ([1, vocab], [-1], ["x"], [[1]]):
            code, out = _http(base + "/v1/generate", {"tokens": tokens})
            assert code == 400 and out["status"] == "rejected", tokens
        with pytest.raises(InvalidRequest):
            batcher.submit([vocab + 7])
        assert batcher.pending() == 0
        code, health = _http(base + "/healthz")
        assert code == 200
        prompt = [7, 3, 11, 2]
        code, out = _http(base + "/v1/generate",
                          {"tokens": prompt, "max_new_tokens": 4})
        assert code == 200 and out["status"] == "ok", out
        assert out["tokens"] == cases.greedy_decode(step, prompt, 4, 32, 8)
    finally:
        fe.stop()
        loop.stop()


# ---------------------------------------------------------------------------
# router


def _entries(*specs):
    return [{"id": i, "addr": "127.0.0.1", "port": p, "rank": r}
            for i, p, r in specs]


def test_router_least_loaded_and_reroute_on_death():
    reg = MetricsRegistry()
    router = RequestRouter(retry_limit=2, registry=reg)
    router.update_workers(_entries(("a", 1001, 0), ("b", 1002, 1)), 0)
    dead = {"a"}
    served = []

    def send(worker, payload):
        if worker.id in dead:
            raise ConnectionRefusedError("worker gone")
        served.append(worker.id)
        return {"status": "ok", "id": payload["id"]}

    out = router.submit("r1", {"id": "r1"}, send)
    assert out["status"] == "ok"
    assert served == ["b"]  # a died, b absorbed the re-route
    from horovod_tpu_torch.metrics import snapshot_value
    snap = reg.snapshot()
    assert snapshot_value(snap, "hvd_serve_rerouted_total") == 1
    assert snapshot_value(snap, "hvd_serve_lost_total") == 0
    states = {w["id"]: w["state"] for w in router.workers()}
    assert states["a"] == "dead" and states["b"] == "up"


def test_router_exhausted_retries_is_loud_not_silent():
    reg = MetricsRegistry()
    router = RequestRouter(retry_limit=1, registry=reg)
    router.update_workers(_entries(("a", 1001, 0)), 0)

    def send(worker, payload):
        raise ConnectionResetError("down")

    with pytest.raises(NoWorkersError):
        router.submit("r1", {"id": "r1"}, send)
    from horovod_tpu_torch.metrics import snapshot_value
    assert snapshot_value(reg.snapshot(), "hvd_serve_lost_total") == 1


def test_router_generation_change_drains_and_reroutes():
    router = RequestRouter(retry_limit=1, registry=MetricsRegistry())
    router.update_workers(_entries(("a", 1001, 0), ("b", 1002, 1)), 0)
    wa = router.pick()  # least-loaded, tie by id -> a
    assert wa.id == "a"
    router.assign(wa, "req-a")
    # generation change: a is gone from the topology, c joined
    router.update_workers(_entries(("b", 1002, 1), ("c", 1003, 2)), 1)
    states = {w["id"]: w["state"] for w in router.workers()}
    assert states["a"] == "draining"
    # draining workers take no new traffic
    assert {router.pick().id for _ in range(4)} <= {"b", "c"}
    # its in-flight request finishes on the departing worker, then the
    # worker leaves the table entirely
    router.complete(wa, "req-a")
    assert "a" not in {w["id"] for w in router.workers()}
    assert router.generation == 1


def test_router_reregistered_worker_resumes():
    router = RequestRouter(registry=MetricsRegistry())
    router.update_workers(_entries(("a", 1001, 0), ("b", 1002, 1)), 0)
    router.update_workers(_entries(("b", 1002, 1)), 1)  # a drains
    router.update_workers(_entries(("a", 1001, 0), ("b", 1002, 1)), 2)
    states = {w["id"]: w["state"] for w in router.workers()}
    assert states["a"] == "up"  # rejoined the rotation


def test_router_stale_gen0_record_cannot_revive_corpse():
    """A dead worker's own stale KV record — explicit generation 0, the
    falsy one — must not resurrect it when the table moves to a later
    generation; only a strictly newer *registration* revives the id."""
    router = RequestRouter(registry=MetricsRegistry())
    e = dict(_entries(("a", 1001, 0))[0], generation=0)
    router.update_workers([e], 0)
    router.fail_worker("a")
    # the driver republishes the stale gen-0 record under table gen 1
    router.update_workers([e], 1)
    assert {w["id"]: w["state"] for w in router.workers()}["a"] == "dead"
    # the respawned slot re-registers under generation 1: revived
    router.update_workers([dict(e, generation=1)], 1)
    assert {w["id"]: w["state"] for w in router.workers()}["a"] == "up"


def test_router_refresh_from_kv():
    """The driver's serve_targets key, served by the reference's KVServer,
    read through the port's KVClient; a KV outage keeps the table and
    flips discovery_stale."""
    from horovod_tpu.runner.http_kv import KVServer
    from horovod_tpu_torch.runner.http_kv import KVClient
    kv = KVServer().start()
    try:
        client = KVClient("127.0.0.1", kv.port)
        router = RequestRouter(registry=MetricsRegistry())
        kv.put_json("serve_targets",
                    {"generation": 3,
                     "workers": _entries(("x", 1009, 0))})
        assert router.refresh_from_kv(
            lambda k: client.get_json(k, timeout=2.0))
        assert router.generation == 3
        assert [w["id"] for w in router.workers()] == ["x"]
    finally:
        kv.stop()
    assert not router.refresh_from_kv(
        lambda k: client.get_json(k, timeout=0.5))
    assert router.discovery_stale
    assert [w["id"] for w in router.workers()] == ["x"]


# ---------------------------------------------------------------------------
# frontend


def _http(url, payload=None, timeout=10.0):
    if payload is None:
        req = url
    else:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urlerror.HTTPError as e:
        return e.code, json.loads(e.read())


def test_frontend_local_roundtrip_reject_and_drain():
    reg, batcher, loop = _stack(queue_depth=2)
    loop.start()
    fe = ServeFrontend(batcher=batcher, port=0, addr="127.0.0.1",
                       registry=reg).start()
    base = f"http://127.0.0.1:{fe.port}"
    try:
        code, out = _http(base + "/v1/generate",
                          {"tokens": [1, 2, 3], "max_new_tokens": 3})
        assert code == 200 and out["status"] == "ok"
        assert out["tokens"] == _toy_reference([1, 2, 3], 3)
        code, health = _http(base + "/healthz")
        assert code == 200 and health["status"] == "ok"
        code, stats = _http(base + "/stats")
        assert code == 200 and stats["requests_ok"] == 1
        assert stats["latency_p50_ms"] is not None
        # drain flips health to 503 and rejects new work
        fe.set_draining(True)
        code, health = _http(base + "/healthz")
        assert code == 503 and health["status"] == "draining"
        code, out = _http(base + "/v1/generate", {"tokens": [1]})
        assert code == 503
    finally:
        fe.stop()
        loop.stop()


def test_routed_frontend_end_to_end_with_drain_on_death():
    """Cluster shape in one process: two local worker stacks behind an
    ingress router frontend. Killing one worker's HTTP server mid-run
    re-routes to the survivor; nothing accepted is lost."""
    workers = []
    for _ in range(2):
        reg, batcher, loop = _stack()
        loop.start()
        fe = ServeFrontend(batcher=batcher, port=0, addr="127.0.0.1",
                           registry=reg).start()
        workers.append((batcher, loop, fe))
    reg_r = MetricsRegistry()
    router = RequestRouter(retry_limit=2, registry=reg_r)
    router.update_workers(
        [{"id": f"w{i}", "addr": "127.0.0.1", "port": w[2].port, "rank": i}
         for i, w in enumerate(workers)], 0)
    ingress = ServeFrontend(router=router, port=0, addr="127.0.0.1",
                            registry=reg_r).start()
    base = f"http://127.0.0.1:{ingress.port}"
    try:
        oks = 0
        for i in range(6):
            code, out = _http(base + "/v1/generate",
                              {"tokens": [i], "max_new_tokens": 2,
                               "id": f"req{i}"})
            assert code == 200 and out["status"] == "ok", out
            oks += 1
            if i == 2:  # kill worker 0's HTTP server mid-load
                workers[0][2].stop()
                workers[0][1].stop()
        assert oks == 6
        from horovod_tpu_torch.metrics import snapshot_value
        assert snapshot_value(reg_r.snapshot(),
                              "hvd_serve_lost_total") in (None, 0.0)
        states = {w["id"]: w["state"] for w in router.workers()}
        assert states.get("w0", "dead") == "dead"
    finally:
        ingress.stop()
        for _, loop, fe in workers[1:]:
            fe.stop()
            loop.stop()


def test_serving_stats_summary():
    reg, batcher, loop = _stack()
    loop.start()
    try:
        for i in range(3):
            r = batcher.submit([i, i], max_new_tokens=2)
            assert r.wait(10.0)
        stats = serving_stats(reg.snapshot())
        assert stats["requests_ok"] == 3
        assert stats["tokens_out"] == 6
        assert stats["latency_p99_ms"] is not None
        assert stats["batch_occupancy_mean"] is not None
    finally:
        loop.stop()


# ---------------------------------------------------------------------------
# serve worker: drain, KV registration, the entry point, the heartbeat


def test_serve_worker_drains_instead_of_dropping():
    from horovod_tpu_torch.serve.worker import ServeWorker
    step_base = make_toy_step()

    def slow_step(tokens, lengths):
        time.sleep(0.02)
        return step_base(tokens, lengths)

    w = ServeWorker(step_fn=slow_step)
    w.start()
    base = f"http://127.0.0.1:{w.frontend.port}"
    results = {}

    def client(i):
        results[i] = _http(base + "/v1/generate",
                           {"tokens": [i], "max_new_tokens": 8,
                            "deadline_ms": 5000})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.08)  # requests admitted and mid-generation
    assert w.drain(timeout=15.0)
    for t in threads:
        t.join(timeout=15.0)
    try:
        # every accepted request completed despite the drain
        assert all(code == 200 and out["status"] == "ok"
                   for code, out in results.values()), results
        code, health = _http(base + "/healthz")
        assert code == 503
    finally:
        w.stop()


# ---------------------------------------------------------------------------
# serving fast path: paged KV cache + prefix reuse + speculative decode


def _fast_stack(draft=None, spec_k=None, spec_sync=None, pool_blocks=64,
                block_tokens=8, **kw):
    """Fresh toy stack behind a block-paged cache, isolated registry."""
    from horovod_tpu_torch.serve.executor import make_toy_cached_step
    from horovod_tpu_torch.serve.kv_cache import PagedKVCache
    reg = MetricsRegistry()
    cache = PagedKVCache(block_tokens=block_tokens,
                         pool_blocks=pool_blocks, registry=reg)
    kw.setdefault("max_batch", 4)
    kw.setdefault("queue_depth", 8)
    kw.setdefault("default_deadline_ms", 2000.0)
    kw.setdefault("max_len", 128)
    batcher = ContinuousBatcher(registry=reg, cache=cache, **kw)
    loop = ServingLoop(make_toy_step(), batcher, registry=reg,
                       cached_step=make_toy_cached_step(),
                       draft_step=draft, spec_k=spec_k,
                       spec_sync=spec_sync)
    return reg, batcher, loop


def test_cached_decode_matches_toy_reference():
    """The fast path changes the cost model (O(1)/token vs O(L)), never
    the tokens."""
    _, batcher, loop = _fast_stack()
    loop.start()
    try:
        reqs = [batcher.submit([i, i + 1, i + 2], max_new_tokens=5)
                for i in range(3)]
        for i, r in enumerate(reqs):
            assert r.wait(10.0) and r.status == "ok"
            assert r.generated == _toy_reference([i, i + 1, i + 2], 5)
    finally:
        loop.stop()
    assert batcher.cache.balanced()


def test_queued_expired_never_allocates_cache_blocks():
    """Expiry-split regression, queued half: a request that dies in the
    queue charged capacity but provably never bound a physical block."""
    from horovod_tpu_torch.metrics import snapshot_value
    reg, batcher, _ = _fast_stack()  # loop not started: stays queued
    req = batcher.submit([1, 2, 3], max_new_tokens=4, deadline_ms=10.0)
    assert req.lease.charged > 0 and req.lease.bound == 0
    time.sleep(0.05)
    assert batcher.fill([]) == []  # expired at scheduling time
    assert req.status == "expired" and req.generated == []
    assert req.lease.bound == 0  # the invariant release() enforces
    st = batcher.cache.stats()
    assert st["free"] == st["pool_blocks"] and batcher.cache.balanced()
    assert snapshot_value(reg.snapshot(),
                          "hvd_serve_cache_blocks_used") == 0


def test_running_expired_frees_exactly_the_charge():
    """Expiry-split regression, running half: a mid-generation expiry
    returns partial output AND its full block charge at that same step
    boundary."""
    from horovod_tpu_torch.metrics import snapshot_value
    from horovod_tpu_torch.serve.executor import (CachedStep,
                                                  make_toy_cached_step)
    base = make_toy_cached_step()

    class Slow(CachedStep):
        state_dim = base.state_dim

        def advance(self, *a):
            time.sleep(0.03)
            return base.advance(*a)

    from horovod_tpu_torch.serve.kv_cache import PagedKVCache
    reg = MetricsRegistry()
    cache = PagedKVCache(block_tokens=8, pool_blocks=64, registry=reg)
    batcher = ContinuousBatcher(max_batch=4, queue_depth=8, max_len=128,
                                default_deadline_ms=2000.0, registry=reg,
                                cache=cache)
    loop = ServingLoop(make_toy_step(), batcher, registry=reg,
                       cached_step=Slow()).start()
    try:
        req = batcher.submit([5, 6], max_new_tokens=32, deadline_ms=120.0)
        charged = req.lease.charged
        assert charged == 5  # ceil((2 + 32) / 8): the worst case upfront
        assert req.wait(10.0) and req.status == "expired"
        assert 0 < len(req.generated) < 32  # partial output returned
    finally:
        loop.stop()
    assert req.lease.closed and req.lease.charged == 0
    st = cache.stats()
    assert st["free"] == st["pool_blocks"], st  # the charge came back
    assert cache.balanced()
    assert snapshot_value(reg.snapshot(),
                          "hvd_serve_cache_blocks_used") == 0


def test_cache_churn_1k_requests_no_leak():
    """1k requests of mixed fate — ok, queued-expired, running-expired,
    rejected — leave the pool exactly conserved: every non-shared block
    back in the free list, used gauge == resident shared blocks."""
    from horovod_tpu_torch.metrics import snapshot_value
    reg, batcher, loop = _fast_stack(queue_depth=64, pool_blocks=96,
                                     default_deadline_ms=500.0)
    loop.start()
    prefixes = [[t] * 24 for t in (3, 5, 7)]  # 3 shared tenant prompts
    outcomes = {"submitted": 0, "rejected": 0}
    reqs = []
    try:
        for i in range(1000):
            tokens = prefixes[i % 3] + [i % 251]
            ddl = 0.5 if i % 7 == 0 else 500.0  # ~14% expire somewhere
            try:
                reqs.append(batcher.submit(tokens, max_new_tokens=4,
                                           deadline_ms=ddl))
                outcomes["submitted"] += 1
            except AdmissionRejected:
                outcomes["rejected"] += 1
            if i % 50 == 49:  # let the loop breathe; keeps some bursts
                for r in reqs[-20:]:
                    r.wait(5.0)
        for r in reqs:
            assert r.wait(10.0), r.status
    finally:
        loop.drain(timeout=10.0)
        loop.stop()
    assert outcomes["submitted"] >= 900  # the churn actually churned
    assert all(r.status in ("ok", "expired") for r in reqs)
    assert any(r.status == "expired" for r in reqs)
    cache = batcher.cache
    assert cache.balanced(), cache.stats()
    st = cache.stats()
    # nothing private leaked: all non-resident-shared capacity is free
    assert st["charged"] == 0
    assert st["free"] + st["shared_resident"] == st["pool_blocks"]
    snap = reg.snapshot()
    assert snapshot_value(snap, "hvd_serve_cache_blocks_used") == \
        st["shared_resident"]
    # the shared tenant prompts actually got reused
    assert (snapshot_value(snap, "hvd_serve_cache_reuse_total") or 0) > 0


def test_cache_exhaustion_is_admission_backpressure():
    """A pool too small for the request is a 429 at submit, before the
    queue — never an OOM later."""
    from horovod_tpu_torch.metrics import snapshot_value
    reg, batcher, _ = _fast_stack(pool_blocks=2, block_tokens=8)
    with pytest.raises(AdmissionRejected, match="exhausted"):
        batcher.submit(list(range(20)), max_new_tokens=20)  # needs 5
    snap = reg.snapshot()
    assert snapshot_value(snap, "hvd_serve_requests_total",
                          status="rejected") == 1
    assert snapshot_value(snap, "hvd_serve_cache_exhausted_total") == 1
    assert batcher.cache.balanced()


def test_prefix_reuse_skips_prefill_compute():
    """Second request with the same prompt resumes from the published
    checkpoint: hits > 0, prefill tokens saved, and the tokens still
    match the reference exactly."""
    from horovod_tpu_torch.metrics import snapshot_value
    reg, batcher, loop = _fast_stack(block_tokens=8)
    prompt = [9] * 20  # 2 full blocks + partial
    loop.start()
    try:
        first = batcher.submit(prompt, max_new_tokens=4)
        assert first.wait(10.0) and first.status == "ok"
        second = batcher.submit(prompt, max_new_tokens=4)
        assert second.wait(10.0) and second.status == "ok"
    finally:
        loop.stop()
    assert first.generated == second.generated == \
        _toy_reference(prompt, 4)
    snap = reg.snapshot()
    assert (snapshot_value(snap, "hvd_serve_cache_hits_total") or 0) > 0
    assert (snapshot_value(
        snap, "hvd_serve_cache_prefill_tokens_saved_total") or 0) >= 16
    assert batcher.cache.balanced()


def test_spec_decode_token_identical_toy_with_rejects():
    """Speculative decoding with a deliberately-wrong draft: the reject
    path engages (accepted < proposed) and the output is still
    token-identical to the non-speculative greedy reference."""
    from horovod_tpu_torch.metrics import snapshot_value
    from horovod_tpu_torch.serve.executor import make_toy_draft_step
    reg, batcher, loop = _fast_stack(
        draft=make_toy_draft_step(wrong_every=3), spec_k=4)
    loop.start()
    try:
        reqs = [batcher.submit([i + 1, 2 * i], max_new_tokens=12)
                for i in range(4)]
        for i, r in enumerate(reqs):
            assert r.wait(10.0) and r.status == "ok"
            assert r.generated == _toy_reference([i + 1, 2 * i], 12)
    finally:
        loop.stop()
    snap = reg.snapshot()
    proposed = snapshot_value(snap, "hvd_serve_spec_proposed_total")
    accepted = snapshot_value(snap, "hvd_serve_spec_accepted_total")
    assert proposed and accepted  # speculation ran and accepted some
    assert accepted < proposed    # ... and the reject path was exercised
    assert batcher.cache.balanced()






def test_spec_decode_token_identical_rnn_vs_plain_step():
    """The acceptance pin on the port's recurrent LM (torch ops): cached +
    speculative greedy decode emits exactly the plain recompute StepFn's
    tokens, which are the reference's numpy LM's."""
    from horovod_tpu.serve.executor import make_rnn_lm_step as ref_make
    from horovod_tpu_torch.serve.executor import make_rnn_lm_step
    from horovod_tpu_torch.serve.kv_cache import PagedKVCache
    step_fn, cached, draft, _ = make_rnn_lm_step(hidden=32, vocab=64,
                                                 seed=1, device="cpu")
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9]]

    def decode(fast, step=step_fn):
        reg = MetricsRegistry()
        cache = PagedKVCache(block_tokens=8, pool_blocks=64,
                             registry=reg) if fast else None
        batcher = ContinuousBatcher(max_batch=4, queue_depth=8,
                                    max_len=64, registry=reg, cache=cache,
                                    default_deadline_ms=5000.0)
        loop = ServingLoop(step, batcher, registry=reg,
                           cached_step=cached if fast else None,
                           draft_step=draft if fast else None,
                           spec_k=4).start()
        try:
            reqs = [batcher.submit(p, max_new_tokens=10) for p in prompts]
            for r in reqs:
                assert r.wait(20.0) and r.status == "ok"
            return [r.generated for r in reqs]
        finally:
            loop.stop()

    plain = decode(False)
    assert decode(True) == plain
    assert decode(False, ref_make(hidden=32, vocab=64, seed=1)[0]) == plain


def test_spec_sync_hook_gets_the_accept_counts():
    """Each speculative step hands its per-row accept counts (int32, 4
    bytes a row) to the ``spec_sync`` hook, which a worker wires to a
    small collective."""
    from horovod_tpu_torch.serve.executor import make_toy_draft_step
    seen = []

    def spec_sync(accepts):
        seen.append(np.asarray(accepts).copy())
        return accepts

    _, batcher, loop = _fast_stack(draft=make_toy_draft_step(wrong_every=3),
                                   spec_k=4, spec_sync=spec_sync)
    loop.start()
    try:
        reqs = [batcher.submit([i, i + 2], max_new_tokens=8)
                for i in range(3)]
        for i, r in enumerate(reqs):
            assert r.wait(20.0) and r.status == "ok"
            assert r.generated == _toy_reference([i, i + 2], 8)
    finally:
        loop.stop()
    assert seen and all(a.dtype == np.int32 and a.nbytes <= 4 * 4
                        for a in seen)
    assert all((0 <= a).all() and (a <= 4).all() for a in seen)


def test_serve_worker_registers_in_kv():
    """register() publishes the endpoint under serve_addr/<host>/<slot>
    (the reference's key and record, through the port's KV client);
    deregister() removes it."""
    from horovod_tpu_torch.runner.http_kv import KVClient
    from horovod_tpu_torch.serve.worker import ServeWorker
    kv = cases.StandInKV()
    w = ServeWorker(step_fn=make_toy_step()).start()
    try:
        w.register(KVClient("127.0.0.1", kv.port), generation=2)
        host = socket.gethostname()
        rec = kv.get_json(f"serve_addr/{host}/0")
        assert rec == {"id": f"{host}/0", "addr": host,
                       "port": w.frontend.port, "rank": 0,
                       "generation": 2}
        w.deregister()
        assert kv.get_json(f"serve_addr/{host}/0") is None
    finally:
        w.stop()
        kv.stop()


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, **{k: str(v) for k, v in extra.items()})
    return env


def _wait_for(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.1)
    pytest.fail(f"timed out waiting for {what}")


def test_serve_worker_main_serves_then_stops_on_serve_stop():
    """``python -m horovod_tpu_torch.serve.worker`` as a process: it
    registers its endpoint in the rendezvous KV, serves the default fast
    path (toy model behind the paged cache) over HTTP, and exits 0 after
    draining once the KV publishes serve_stop."""
    kv = cases.StandInKV()
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serve.worker"],
        env=_env(HOROVOD_RENDEZVOUS_ADDR="127.0.0.1",
                 HOROVOD_RENDEZVOUS_PORT=kv.port, HOROVOD_HOSTNAME="hostA",
                 HOROVOD_SERVE_PORT=0),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        rec = _wait_for(lambda: kv.get_json("serve_addr/hostA/0"), 60,
                        "the worker's registration")
        base = f"http://127.0.0.1:{rec['port']}"
        code, out = _http(base + "/v1/generate",
                          {"tokens": [4, 5, 6], "max_new_tokens": 3})
        assert code == 200 and out["tokens"] == _toy_reference([4, 5, 6], 3)
        code, stats = _http(base + "/stats")
        assert stats["cache"]["pool_balanced"] is True
        kv.put_json("serve_stop", {"ts": time.time()})
        assert proc.wait(timeout=30) == 0, proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        kv.stop()


def test_heartbeat_fails_as_horovod_internal_error_when_a_peer_dies():
    """Two serve workers of a static job (gloo, world 2): each beats a
    16-element allreduce on the eager data group. Rank 1 is killed; rank
    0's next beat raises HorovodInternalError, and a static job cannot
    heal: it drains what it accepted and exits 1."""
    port = cases.free_port()
    http = [cases.free_port() for _ in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serve.worker",
         "--device", "cpu"],
        env=_env(HOROVOD_RANK=r, HOROVOD_SIZE=2, HOROVOD_LOCAL_RANK=r,
                 HOROVOD_GLOO_TIMEOUT_SECONDS=10, MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port, HOROVOD_SERVE_PORT=http[r]),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]

    def serving(r):
        try:
            return _http(f"http://127.0.0.1:{http[r]}/healthz",
                         timeout=1.0)[0] == 200
        except OSError:
            return False
    try:
        # a worker serves once it has joined the job's groups
        for r in range(2):
            _wait_for(lambda: serving(r) or procs[r].poll() is not None,
                      120, f"worker {r} to serve")
            assert procs[r].poll() is None, procs[r].stdout.read()
        time.sleep(1.0)  # a few beats; then rank 1 dies hard
        procs[1].kill()
        assert procs[0].wait(timeout=60) == 1
        log = procs[0].stdout.read()
        assert "heartbeat collective failed" in log, log
        # the message translate_failures gives the HorovodInternalError
        assert "heartbeat collective failed (collective failed:" in log, log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_hvd_serve_main_serves_the_tp_lm():
    """The port's ``hvd-serve`` (``python -m
    horovod_tpu_torch.serve.frontend``) on the CPU: the TP LM at the
    reference hvd-serve's size on the int8 wire behind the HTTP frontend;
    its greedy tokens are those of the same step built in this process."""
    from horovod_tpu_torch.serve.executor import make_tp_lm_step
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serve.frontend",
         "--device", "cpu", "--port", "0"],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        seen = []
        for line in proc.stdout:  # runpy warns first: serve/__init__
            seen.append(line)     # imports the frontend module
            if "listening on :" in line:
                break
        assert "compression=int8" in line, seen
        port = int(line.split("listening on :")[1].split()[0])
        code, out = _http(f"http://127.0.0.1:{port}/v1/generate",
                          {"tokens": [7, 256], "max_new_tokens": 4})
        assert code == 400 and "outside the vocabulary" in out["error"]
        prompt = [7, 3, 11, 2]
        code, out = _http(f"http://127.0.0.1:{port}/v1/generate",
                          {"tokens": prompt, "max_new_tokens": 4})
        assert code == 200 and out["status"] == "ok", out
        step, _ = make_tp_lm_step(compression="int8", device="cpu",
                                  axis=None)
        assert out["tokens"] == cases.greedy_decode(step, prompt, 4, 32, 8)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_loadgen_trace_and_open_loop_window():
    """The shared-prefix trace is the reference's for the same seed and
    knobs; one open-loop window over the toy stack accounts for every
    request (ok + rejected + expired + failed + unsettled), with the
    percentiles of the ok ones."""
    from horovod_tpu.serve import loadgen as ref
    from horovod_tpu_torch.serve import loadgen
    kw = dict(seed=3, requests=40, tenants=3, prefix_len=24, tail_len=4,
              max_new_tokens=3, vocab=97)
    trace = loadgen.shared_prefix_trace(**kw)
    assert trace == ref.shared_prefix_trace(**kw)
    assert loadgen.percentile([3.0, 1.0, 2.0], 0.5) == \
        ref.percentile([3.0, 1.0, 2.0], 0.5) == 2.0
    _, batcher, loop = _stack(max_len=64)
    loop.start()

    def submit(payload):
        try:
            req = batcher.submit(payload["tokens"],
                                 max_new_tokens=payload["max_new_tokens"])
        except AdmissionRejected:
            return {"status": "rejected"}
        req.wait(10.0)
        return req.result()
    try:
        (window,) = loadgen.run_points(
            submit, loadgen.trace_payload_fn(trace), [40.0],
            duration_sec=0.5)
    finally:
        loop.drain(10.0)
        loop.stop()
    assert window["requests"] == 20
    assert window["completed_ok"] + window["rejected"] + \
        window["expired"] + window["failed"] + window["unsettled"] == 20
    assert window["completed_ok"] > 0 and window["p99_ms"] is not None


@pytest.mark.parametrize("qps", [0.0, 0.001])
def test_admission_verdicts_match_reference(qps):
    """Priority-class shedding and tenant quotas, port and reference in
    lockstep over one sequence of bodies and queue fills: the same
    verdicts, classes and counters."""
    from horovod_tpu.metrics.registry import MetricsRegistry as RefReg
    from horovod_tpu.serve.admission import AdmissionController as Ref
    from horovod_tpu_torch.serve.admission import (AdmissionController,
                                                   parse_priority_classes)
    classes = parse_priority_classes("batch,standard,premium")
    mine = AdmissionController(classes, tenant_qps=qps, tenant_burst=2,
                               registry=MetricsRegistry())
    ref = Ref(classes, tenant_qps=qps, tenant_burst=2, registry=RefReg())
    rng = np.random.RandomState(4)
    for _ in range(60):
        body = {}
        if rng.rand() < 0.8:
            body["priority"] = str(rng.choice(
                ["batch", "standard", "premium", "bogus"]))
        if rng.rand() < 0.5:
            body["tenant"] = f"t{rng.randint(3)}"
        fill = float(rng.rand())
        a, b = mine.admit(body, fill), ref.admit(body, fill)
        assert (a.ok, a.cls, a.reason) == (b.ok, b.cls, b.reason), body
    assert mine.counters() == ref.counters()
