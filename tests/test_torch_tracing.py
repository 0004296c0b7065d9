"""The port's request tracing (horovod_tpu_torch/obs/tracing.py) through
its serving plane, case for case the reference's tests/test_tracing.py:
the sampling decision is made once at ingress and adopted downstream; a
sampled request renders as one Perfetto timeline whose spans cover
admission, queue wait, cache lookup, prefill, draft/verify and decode
steps; the trace id is echoed in every HTTP response, 429s included; the
unsampled fast path records nothing. Then the JSON half of trace_merge
against the reference's on the same events.

Every test swaps the process-global tracer via ``tracing.configure`` and
restores the env-configured default after.
"""

import json

import pytest

from horovod_tpu_torch.metrics.registry import MetricsRegistry
from horovod_tpu_torch.obs import tracing
from horovod_tpu_torch.obs.tracing import (ADMISSION, CACHE_LOOKUP,
                                           DECODE_STEP, DRAFT, PREFILL,
                                           QUEUE_WAIT, SPAN_KINDS, VERIFY,
                                           Tracer)
from horovod_tpu_torch.serve.batcher import ContinuousBatcher
from horovod_tpu_torch.serve.executor import (ServingLoop,
                                              make_toy_cached_step,
                                              make_toy_draft_step,
                                              make_toy_step)
from horovod_tpu_torch.serve.frontend import ServeFrontend


@pytest.fixture
def traced_all():
    """Global tracer at sample=1.0 for the test, restored after."""
    tracer = tracing.configure(sample=1.0, buffer_spans=4096)
    try:
        yield tracer
    finally:
        tracing.configure()  # back to env defaults (sample 0.0)


def _spec_stack(**kw):
    """Full fast-path stack: paged cache + speculative decode, so a traced
    request exercises every executor span kind."""
    from horovod_tpu_torch.serve.kv_cache import PagedKVCache
    reg = MetricsRegistry()
    cache = PagedKVCache(block_tokens=8, pool_blocks=64, registry=reg)
    kw.setdefault("max_batch", 4)
    kw.setdefault("queue_depth", 8)
    kw.setdefault("default_deadline_ms", 5000.0)
    kw.setdefault("max_len", 128)
    batcher = ContinuousBatcher(registry=reg, cache=cache, **kw)
    loop = ServingLoop(make_toy_step(), batcher, registry=reg,
                       cached_step=make_toy_cached_step(),
                       draft_step=make_toy_draft_step(), spec_k=4)
    return reg, batcher, loop


# ---------------------------------------------------------------------------
# sampling / propagation unit behavior


def test_sampling_off_is_the_null_fast_path():
    t = Tracer(sample=0.0, buffer_spans=16)
    assert t.maybe_trace() is None
    sp = t.span(None, DECODE_STEP, "executor")
    assert sp is tracing._NULL_SPAN  # shared singleton: zero allocation
    with sp:
        pass
    t.record(None, DECODE_STEP, "executor", 0.0, 1.0)
    assert t.spans() == []


def test_sampling_on_mints_distinct_ids():
    t = Tracer(sample=1.0, buffer_spans=16)
    ids = {t.maybe_trace() for _ in range(8)}
    assert None not in ids and len(ids) == 8


def test_downstream_adopts_and_never_resamples():
    """A worker behind an ingress router adopts the inbound id even when
    its OWN sampling says no — one decision per request, at ingress."""
    worker = Tracer(sample=0.0, buffer_spans=16)
    body = Tracer.inject({"prompt": "hi"}, "abc123")
    assert body["trace"] == {"id": "abc123"}
    assert worker.adopt_or_start(body) == "abc123"
    # and injecting None leaves the body untraced (fast path preserved)
    assert "trace" not in Tracer.inject({"prompt": "hi"}, None)
    assert worker.adopt_or_start({"prompt": "hi"}) is None


def test_span_buffer_is_bounded():
    t = Tracer(sample=1.0, buffer_spans=4)
    for i in range(10):
        t.record("tid", DECODE_STEP, "executor", float(i), 1.0, step=i)
    kept = t.spans("tid")
    assert len(kept) == 4  # old spans fell off the back, no growth
    assert [e["args"]["step"] for e in kept] == [6, 7, 8, 9]


def test_span_context_manager_records_errors():
    t = Tracer(sample=1.0, buffer_spans=16)
    with pytest.raises(ValueError):
        with t.span("tid", ADMISSION, "frontend"):
            raise ValueError("shed")
    (event,) = t.spans("tid")
    assert "ValueError" in event["args"]["error"]
    assert event["ph"] == "X" and event["tid"] == "frontend"


# ---------------------------------------------------------------------------
# end-to-end: one sampled request, one timeline


def test_sampled_request_covers_six_span_kinds(traced_all):
    """A sampled request through the full local
    stack (admission -> queue -> cache -> prefill -> spec decode) yields
    >= 6 distinct span kinds under ONE trace id."""
    _, batcher, loop = _spec_stack()
    frontend = ServeFrontend(batcher=batcher)
    loop.start()
    try:
        code, payload = frontend.handle_generate(
            {"tokens": [1, 2, 3, 4, 5, 6, 7, 8, 9], "max_new_tokens": 8})
        assert code == 200 and payload["status"] == "ok"
        tid = payload["trace_id"]
        spans = traced_all.spans(tid)
        kinds = {e["name"] for e in spans}
        assert kinds >= {ADMISSION, QUEUE_WAIT, CACHE_LOOKUP, PREFILL,
                         DRAFT, VERIFY, DECODE_STEP}
        assert len(kinds) >= 6
        # every span carries the id; lanes name the emitting component
        assert all(e["args"]["trace"] == tid for e in spans)
        assert {e["tid"] for e in spans} >= {"frontend", "batcher",
                                             "kv_cache", "executor"}
    finally:
        loop.stop()
        frontend._httpd.server_close()


def test_trace_id_echoed_on_429(traced_all):
    """The echo contract covers rejections: a shed client still gets the
    id to hand to the operator."""
    _, batcher, loop = _spec_stack(queue_depth=1)  # loop NOT started
    frontend = ServeFrontend(batcher=batcher)
    try:
        batcher.submit([1], max_new_tokens=1)  # fill the queue
        code, payload = frontend.handle_generate(
            {"tokens": [2], "max_new_tokens": 1})
        assert code == 429 and payload["status"] == "rejected"
        tid = payload["trace_id"]
        assert tid
        # the admission span exists and records the shed attempt
        kinds = {e["name"] for e in traced_all.spans(tid)}
        assert ADMISSION in kinds
    finally:
        frontend._httpd.server_close()


def test_unsampled_request_records_nothing(traced_all):
    """sample=0: no spans, no trace_id key in the response — the fast
    path is observably absent, not merely cheap."""
    tracer = tracing.configure(sample=0.0, buffer_spans=64)
    _, batcher, loop = _spec_stack()
    frontend = ServeFrontend(batcher=batcher)
    loop.start()
    try:
        code, payload = frontend.handle_generate(
            {"tokens": [1, 2, 3], "max_new_tokens": 2})
        assert code == 200 and payload["status"] == "ok"
        assert "trace_id" not in payload
        assert tracer.spans() == []
    finally:
        loop.stop()
        frontend._httpd.server_close()


def test_export_renders_one_perfetto_timeline(traced_all, tmp_path):
    """Spans export through the trace_merge path into one
    Perfetto-loadable file: a single trace whose events all carry the
    request's id, with cross-process spans folded in via extra_spans."""
    _, batcher, loop = _spec_stack()
    frontend = ServeFrontend(batcher=batcher)
    loop.start()
    try:
        _, payload = frontend.handle_generate(
            {"tokens": list(range(1, 10)), "max_new_tokens": 8})
        tid = payload["trace_id"]
    finally:
        loop.stop()
        frontend._httpd.server_close()
    # a "remote worker's" span fetched by a collector joins the timeline
    remote = [{"name": "re_route", "ph": "X", "ts": 1.0, "dur": 2.0,
               "tid": "router", "args": {"trace": tid}},
              {"name": "re_route", "ph": "X", "ts": 1.0, "dur": 2.0,
               "tid": "router", "args": {"trace": "other-request"}}]
    out = tmp_path / "trace.json"
    doc = traced_all.export(out_path=str(out), trace_id=tid,
                            extra_spans=remote)
    on_disk = json.loads(out.read_text())
    assert on_disk["traceEvents"] == doc["traceEvents"]
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert events, "export produced an empty timeline"
    assert all(e["args"]["trace"] == tid for e in events)
    assert any(e["name"] == "re_route" for e in events)  # merged, filtered
    kinds = {e["name"] for e in events}
    assert len(kinds) >= 6
    assert kinds <= set(SPAN_KINDS) and "other-request" not in json.dumps(doc)


def test_trace_dir_env_names_the_default_export_path(traced_all,
                                                     tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_TRACE_DIR", str(tmp_path / "traces"))
    traced_all.record("deadbeef", DECODE_STEP, "executor", 0.0, 5.0)
    traced_all.export(trace_id="deadbeef")
    written = tmp_path / "traces" / "trace_deadbeef.json"
    assert written.exists()
    doc = json.loads(written.read_text())
    assert any(e.get("name") == DECODE_STEP
               for e in doc["traceEvents"])


@pytest.mark.parametrize("gz", [False, True])
def test_trace_merge_matches_reference(tmp_path, gz):
    """The port's merge_traces gives the reference's trace for the same
    events (a truncated engine-style timeline file, and a second trace
    as a file), bar the producer tag; .gz output round-trips."""
    from horovod_tpu.profiler.trace_merge import merge_traces as ref_merge
    from horovod_tpu_torch.profiler.trace_merge import merge_traces
    timeline = tmp_path / "timeline.json"
    timeline.write_text(
        '[{"name": "QUEUE", "ph": "B", "ts": 1, "tid": "t.a"},'
        '{"name": "QUEUE", "ph": "E", "ts": 5, "tid": "t.a"},'
        '{"name": "EXEC", "ph": "X", "ts": 6, "dur": 2, "tid": "t.b"},'
        '{"name": "tor')  # a killed writer's torn tail
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"traceEvents": [
        {"name": "kernel", "ph": "X", "ts": 3, "dur": 1, "pid": 7,
         "tid": 1}]}))
    out = tmp_path / ("merged.json.gz" if gz else "merged.json")
    got = merge_traces(str(timeline), str(other), out_path=str(out),
                       offset_us=2.0)
    want = ref_merge(str(timeline), str(other), offset_us=2.0)
    assert got["traceEvents"] == want["traceEvents"]
    assert {k: v for k, v in got["metadata"].items() if k != "producer"} \
        == {k: v for k, v in want["metadata"].items() if k != "producer"}
    if gz:
        import gzip
        with gzip.open(out, "rt") as f:
            assert json.load(f) == got
    else:
        assert json.loads(out.read_text()) == got
