"""The port's runtime conformance (``verify/conformance.py``) against the
reference's: the same divergences from the same artifacts. The KV WALs
come from the port's ``KVServer`` (read-only replay against the port's
``common/kv_keys.py``), the journals from the port's journal, the flight
dumps from the seeded synthetic set."""

import base64
import json
import zlib

import pytest

import torch_dist_cases as cases
from horovod_tpu.verify import conformance as ref_conf
from horovod_tpu_torch.common import journal, kv_keys
from horovod_tpu_torch.verify import conformance


def _close(kv):
    kv._httpd.server_close()
    if kv._wal:
        kv._wal.close()


def _driver_shaped_session(kv_dir, snapshot_bytes=None):
    """A port KVServer run shaped like a two-generation elastic job."""
    from horovod_tpu_torch.runner.http_kv import KVServer
    kw = {} if snapshot_bytes is None else {"snapshot_bytes": snapshot_bytes}
    kv = KVServer(port=0, kv_dir=str(kv_dir), **kw)
    epoch = kv.epoch
    for gen in (0, 1):
        for slot in (0, 1):
            kv.put_json(kv_keys.rank_and_size(gen, "localhost", slot),
                        {"rank": slot, "size": 2, "epoch": epoch},
                        epoch=epoch)
            kv.put_json(kv_keys.worker_state(gen, "localhost", slot),
                        {"state": "READY"})
        kv.put_json(kv_keys.generation(),
                    {"generation": gen, "epoch": epoch}, epoch=epoch)
        kv.put_json(kv_keys.go(gen), {"ts": 1.0, "epoch": epoch},
                    epoch=epoch)
        kv.put_json(kv_keys.notify(),
                    {"generation": gen, "epoch": epoch}, epoch=epoch)
    kv.put_json(kv_keys.drain("localhost", 1), {"generation": 1})
    kv.put_json(kv_keys.serve_addr("localhost", 0),
                {"addr": "127.0.0.1", "port": 1})
    kv.delete(kv_keys.go(0), epoch=epoch)
    kv.delete_prefix(kv_keys.rank_and_size_prefix(0), epoch=epoch)
    return kv, epoch


def _append_wal_record(kv_dir, op: dict, wal="wal.log"):
    payload = json.dumps(op).encode()
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    with open(kv_dir / wal, "ab") as f:
        f.write(len(payload).to_bytes(4, "little") +
                crc.to_bytes(4, "little") + payload)


def _b64(doc) -> str:
    return base64.b64encode(json.dumps(doc).encode()).decode()


def _mutate(kind, kv_dir, kv, epoch):
    """Plant one protocol violation into the WAL the port wrote."""
    if kind == "clean":
        return
    if kind == "epoch_regression":
        _append_wal_record(kv_dir, {"op": "put", "k": kv_keys.notify(),
                                    "v": _b64({"generation": 0}),
                                    "e": epoch - 1})
    elif kind == "unregistered_key":
        _append_wal_record(kv_dir, {"op": "put", "k": "rogue_namespace/x",
                                    "v": _b64({})})
    elif kind == "go_before_topology":
        kv.put_json(kv_keys.go(5), {"ts": 1.0, "epoch": epoch}, epoch=epoch)
    elif kind == "generation_regression":
        kv.put_json(kv_keys.generation(), {"generation": 0}, epoch=epoch)
    elif kind == "torn_tail":
        with open(kv_dir / "wal.log", "ab") as f:
            f.write(b"\x10\x00\x00\x00garbage")


MUTATIONS = ("clean", "epoch_regression", "unregistered_key",
             "go_before_topology", "generation_regression", "torn_tail")


@pytest.mark.parametrize("kind", MUTATIONS)
def test_kv_wal_replay_equals_reference(kind, tmp_path):
    kv, epoch = _driver_shaped_session(tmp_path)
    try:
        _mutate(kind, tmp_path, kv, epoch)
    finally:
        _close(kv)
    got = conformance.check_kv_wal(tmp_path)
    assert got == ref_conf.check_kv_wal(tmp_path)
    assert (got == []) == (kind in ("clean", "torn_tail")), got
    assert list(conformance.iter_wal_ops(tmp_path)) == \
        list(ref_conf.iter_wal_ops(tmp_path))


def test_kv_wal_replay_consults_the_snapshot(tmp_path):
    kv, _ = _driver_shaped_session(tmp_path, snapshot_bytes=1)
    _close(kv)
    assert conformance.load_snapshot_keys(tmp_path) == \
        ref_conf.load_snapshot_keys(tmp_path)
    assert conformance.check_kv_wal(tmp_path) == \
        ref_conf.check_kv_wal(tmp_path) == []


def test_not_a_kv_directory(tmp_path):
    assert conformance.check_kv_wal(tmp_path) == \
        ref_conf.check_kv_wal(tmp_path) != []


@pytest.mark.parametrize("scenario", cases.SYNTH_SCENARIOS)
def test_flight_dump_checks_equal_reference(scenario):
    dumps = cases.synthetic_dumps(11, scenario)
    got = conformance.check_flight_dumps(dumps)
    assert got == ref_conf.check_flight_dumps(dumps)
    assert (got == []) == (scenario not in ("desync", "wrap")), got


@pytest.fixture
def journal_dir(tmp_path, monkeypatch):
    d = tmp_path / "journal"
    monkeypatch.setenv("HOROVOD_JOURNAL_DIR", str(d))
    journal._reset_for_tests()
    yield d
    journal._reset_for_tests()


@pytest.mark.parametrize("fault", ["none", "epoch", "generation"])
def test_journal_checks_equal_reference(journal_dir, fault):
    journal.emit("driver", "resize", control_epoch=2, generation=1,
                 slots=2)
    journal.emit("driver", "worker_exit", control_epoch=2, generation=1,
                 host="localhost", local_rank=1, reason="failure",
                 exit_code=-9)
    if fault == "epoch":
        journal.emit("driver", "resize", control_epoch=1, generation=2)
    elif fault == "generation":
        journal.emit("driver", "resize", control_epoch=2, generation=0)
    journal._reset_for_tests()
    got = conformance.check_journal(journal_dir)
    assert got == ref_conf.check_journal(journal_dir)
    assert (got == []) == (fault == "none"), got


def test_check_artifacts_over_one_directory_equals_reference(
        journal_dir, tmp_path):
    kv, _ = _driver_shaped_session(tmp_path / "kv")
    _close(kv)
    journal.emit("driver", "resize", control_epoch=2, generation=1)
    journal._reset_for_tests()
    fdir = tmp_path / "flight"
    fdir.mkdir()
    for r, d in cases.synthetic_dumps(5, "desync").items():
        (fdir / f"flight_rank{r}.json").write_text(json.dumps(d))
    got = conformance.check_artifacts(tmp_path)
    records = got.pop("records")  # the port's own addition
    assert got == ref_conf.check_artifacts(tmp_path)
    assert len(got["checked"]) == 3 and got["divergences"]
    assert sorted(records) == sorted(got["checked"])
    assert all(n > 0 for n in records.values()), records
