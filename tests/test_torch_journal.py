"""The port's event journal (horovod_tpu_torch/common/journal.py), case
for case the journal cases of the reference's tests/test_journal.py:
framing, rotation, retention, crash tolerance, and the emit() front
door's contract that it can never hurt the caller. Then the reference's
replay and conformance auditor read what the port writes, and the worker
side of elastic training journals the reference's records (headless
outage, drain announce and finalize)."""

import json
import os
import threading
import zlib

import pytest

from horovod_tpu_torch.common import journal


@pytest.fixture(autouse=True)
def _fresh_journal(monkeypatch):
    monkeypatch.delenv("HOROVOD_JOURNAL_DIR", raising=False)
    journal._reset_for_tests()
    yield
    journal._reset_for_tests()


def _enable(monkeypatch, tmp_path):
    d = tmp_path / "journal"
    monkeypatch.setenv("HOROVOD_JOURNAL_DIR", str(d))
    journal._reset_for_tests()
    return d


# ---------------------------------------------------------------------------
# emit() front door
# ---------------------------------------------------------------------------

def test_emit_noop_when_unset():
    assert not journal.enabled()
    assert journal.emit("driver", "resize", generation=1) is None


def test_emit_appends_and_replays(monkeypatch, tmp_path):
    d = _enable(monkeypatch, tmp_path)
    journal.emit("driver", "resize", generation=3, slots=4, hosts=2)
    journal.emit("serve", "shed", reason="full", trace_id="t1")
    events = journal.load_events(d)
    assert [e["event"] for e in events] == ["resize", "shed"]
    r = events[0]
    # typed schema: lifted fields top-level, the rest under detail
    assert r["component"] == "driver" and r["generation"] == 3
    assert r["detail"] == {"slots": 4, "hosts": 2}
    assert r["seq"] == 1 and r["pid"] == os.getpid()
    assert r["t_mono"] > 0 and r["t_wall"] > 0
    assert r["id"].endswith(":1")
    assert events[1]["trace_id"] == "t1"


def test_emit_never_raises(monkeypatch, tmp_path):
    # a file where the directory should be: every writer op fails, the
    # caller must never notice
    bad = tmp_path / "notadir"
    bad.write_text("x")
    monkeypatch.setenv("HOROVOD_JOURNAL_DIR", str(bad / "sub"))
    journal._reset_for_tests()
    for _ in range(3):
        assert journal.emit("driver", "x") is None


def test_emit_unserializable_detail_never_raises(monkeypatch, tmp_path):
    d = _enable(monkeypatch, tmp_path)
    journal.emit("driver", "weird", payload=object())
    journal.emit("driver", "after")
    # the poisoned record is dropped, the stream stays usable
    assert "after" in [e["event"] for e in journal.load_events(d)]


# ---------------------------------------------------------------------------
# framing / crash tolerance
# ---------------------------------------------------------------------------

def test_framing_matches_wal(monkeypatch, tmp_path):
    d = _enable(monkeypatch, tmp_path)
    journal.emit("driver", "one")
    seg = next(iter(journal.segment_files(d).values()))[0]
    data = seg.read_bytes()
    length = int.from_bytes(data[:4], "little")
    crc = int.from_bytes(data[4:8], "little")
    payload = data[8:8 + length]
    assert zlib.crc32(payload) & 0xFFFFFFFF == crc
    assert json.loads(payload)["event"] == "one"


def test_replay_stops_at_torn_tail(monkeypatch, tmp_path):
    d = _enable(monkeypatch, tmp_path)
    for i in range(3):
        journal.emit("driver", f"e{i}")
    seg = next(iter(journal.segment_files(d).values()))[0]
    with open(seg, "ab") as f:
        f.write(b"\x40\x00\x00\x00garbage-torn-record")
    events = journal.load_events(d)
    assert [e["event"] for e in events] == ["e0", "e1", "e2"]


def test_replay_stops_at_crc_corruption(monkeypatch, tmp_path):
    d = _enable(monkeypatch, tmp_path)
    journal.emit("driver", "good")
    journal.emit("driver", "flipped")
    seg = next(iter(journal.segment_files(d).values()))[0]
    data = bytearray(seg.read_bytes())
    data[-3] ^= 0xFF  # flip a byte inside the second record's payload
    seg.write_bytes(bytes(data))
    assert [e["event"] for e in journal.load_events(d)] == ["good"]


# ---------------------------------------------------------------------------
# rotation / retention / seq
# ---------------------------------------------------------------------------

def test_rotation_and_retention(tmp_path):
    w = journal.JournalWriter(tmp_path, segment_bytes=256, max_segments=2)
    for i in range(40):
        w.append("driver", f"e{i}")
    files = journal.segment_files(tmp_path)[w.writer_id]
    assert len(files) == 2  # retention pruned the older closed segments
    events = list(journal.iter_journal(tmp_path))
    # the retained tail is contiguous and seq-monotone up to the last
    seqs = [e["seq"] for e in events]
    assert seqs == list(range(seqs[0], 41))
    assert seqs[-1] == 40


def test_rotation_never_deletes_active_segment(tmp_path):
    w = journal.JournalWriter(tmp_path, segment_bytes=200, max_segments=1)
    for i in range(20):
        w.append("driver", f"e{i}")
    files = journal.segment_files(tmp_path)[w.writer_id]
    assert len(files) == 1
    assert files[0] == w.active_path  # the survivor IS the active one
    w.append("driver", "after-retention")
    assert list(journal.iter_segment(w.active_path))


def test_writer_resumes_after_restart(tmp_path):
    w1 = journal.JournalWriter(tmp_path, host="h", pid=7)
    w1.append("driver", "a")
    w1.append("driver", "b")
    w1.close()
    # same (host, pid) writer identity restarting over the same dir must
    # continue, not clobber: new segment index, seq keeps rising
    w2 = journal.JournalWriter(tmp_path, host="h", pid=7)
    w2.append("driver", "c")
    events = list(journal.iter_journal(tmp_path))
    assert [e["event"] for e in events] == ["a", "b", "c"]
    assert [e["seq"] for e in events] == [1, 2, 3]


def test_multi_writer_streams_are_separate(tmp_path):
    wa = journal.JournalWriter(tmp_path, host="hostA", pid=1)
    wb = journal.JournalWriter(tmp_path, host="hostB", pid=2)
    wa.append("driver", "a1")
    wb.append("serve", "b1")
    wa.append("driver", "a2")
    files = journal.segment_files(tmp_path)
    assert len(files) == 2
    by_writer = {}
    for e in journal.iter_journal(tmp_path):
        by_writer.setdefault(e["host"], []).append(e["seq"])
    assert by_writer == {"hostA": [1, 2], "hostB": [1]}


def test_concurrent_emit_seq_monotone(monkeypatch, tmp_path):
    d = _enable(monkeypatch, tmp_path)
    n, threads = 25, 4

    def spam(t):
        for i in range(n):
            journal.emit("driver", f"t{t}e{i}")

    ts = [threading.Thread(target=spam, args=(t,)) for t in range(threads)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    seqs = [e["seq"] for e in journal.load_events(d)]
    assert seqs == list(range(1, n * threads + 1))


# ---------------------------------------------------------------------------
# the reference reads the port's journal
# ---------------------------------------------------------------------------

def test_reference_replay_and_auditor_read_the_port_journal(monkeypatch,
                                                            tmp_path):
    from horovod_tpu.common import journal as ref
    from horovod_tpu.verify import conformance
    d = _enable(monkeypatch, tmp_path)
    journal.emit("driver", "resize", control_epoch=2, generation=1)
    journal.emit("serve", "shed", reason="full", trace_id="t1")
    journal.emit("driver", "resize", control_epoch=2, generation=2)
    assert list(ref.iter_journal(d)) == list(journal.iter_journal(d))
    assert conformance.check_journal(d) == []


def test_reference_auditor_flags_port_regressions(tmp_path):
    from horovod_tpu.verify import conformance
    w = journal.JournalWriter(tmp_path, host="h", pid=1)
    w.append("driver", "resize", control_epoch=3, generation=2)
    w.append("driver", "resize", control_epoch=2, generation=1)
    out = conformance.check_journal(tmp_path)
    assert any("control epoch" in line for line in out)
    assert any("generation" in line for line in out)


# ---------------------------------------------------------------------------
# the worker side of elastic training journals its records
# ---------------------------------------------------------------------------

def test_headless_outage_journals_enter_exit_and_abort(monkeypatch,
                                                       tmp_path):
    """A KV outage: headless_entered on the first failed probe,
    headless_exited (with the replayed writes) on the first success, and
    headless_abort when the outage outlives its deadline."""
    from horovod_tpu_torch.runner.elastic import headless
    d = _enable(monkeypatch, tmp_path)
    headless._reset_for_tests()
    aborted = []
    headless.set_abort_hook(aborted.append)
    try:
        headless.note_failure()
        headless.note_failure()  # the outage goes on: no second record
        headless.queue_write("drain/h/0", {"generation": 1})

        class Client:
            def __init__(self):
                self.puts = []

            def put_json(self, key, value, **kw):
                self.puts.append(key)

        client = Client()
        headless.note_success(client)
        assert client.puts == ["drain/h/0"]
        monkeypatch.setenv("HOROVOD_HEADLESS_DEADLINE_SECONDS", "0.01")
        headless.note_failure()
        import time
        time.sleep(0.03)
        headless.note_failure()
        assert aborted  # the hook replaced the process exit
    finally:
        headless._reset_for_tests()
    events = [(e["component"], e["event"]) for e in journal.iter_journal(d)]
    assert events == [("worker", "headless_entered"),
                      ("worker", "headless_exited"),
                      ("worker", "headless_entered")]
    exited = [e for e in journal.iter_journal(d)
              if e["event"] == "headless_exited"][0]
    assert exited["detail"]["replaying_writes"] == 1


def test_default_headless_abort_journals_before_exiting(monkeypatch,
                                                        tmp_path):
    from horovod_tpu_torch.runner.elastic import headless
    d = _enable(monkeypatch, tmp_path)
    exits = []
    monkeypatch.setattr(headless.os, "_exit", exits.append)
    headless._default_abort(42.0)
    assert exits == [75]
    (rec,) = list(journal.iter_journal(d))
    assert rec["event"] == "headless_abort"
    assert rec["detail"] == {"outage_seconds": 42.0}


def test_preemption_drain_journals_announce_and_finalize(monkeypatch,
                                                         tmp_path):
    """An elastic worker's preemption notice: drain_announce (generation,
    host, slot) once the KV has the drain key, drain_finalize at the
    commit boundary before the clean exit."""
    import torch_dist_cases as cases
    from horovod_tpu_torch.runner.elastic import preempt
    d = _enable(monkeypatch, tmp_path)
    kv = cases.StandInKV()
    for k, v in {"HOROVOD_ELASTIC": "1",
                 "HOROVOD_RENDEZVOUS_ADDR": "127.0.0.1",
                 "HOROVOD_RENDEZVOUS_PORT": str(kv.port),
                 "HOROVOD_HOSTNAME": "hostA", "HOROVOD_LOCAL_RANK": "1",
                 "HOROVOD_ELASTIC_GENERATION": "3"}.items():
        monkeypatch.setenv(k, v)
    preempt._reset_for_tests()
    try:
        preempt._announce()
        assert kv.get_json("drain/hostA/1")["generation"] == 3
        with pytest.raises(SystemExit) as exc:
            preempt.finalize_drain()
        assert exc.value.code == 0
    finally:
        preempt._reset_for_tests()
        kv.stop()
    events = list(journal.iter_journal(d))
    assert [e["event"] for e in events] == ["drain_announce",
                                            "drain_finalize"]
    assert events[0]["generation"] == 3
    assert events[0]["detail"] == {"host": "hostA", "local_rank": "1"}
