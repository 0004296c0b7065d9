"""The port's protocol model checker (``horovod_tpu_torch.verify``) against
the reference's ``hvd-check``: every spec exhaustive and clean at the CI
bound with the reference's state counts (the cycle spec's transitions
differ by design, ROADMAP C26), every mutant caught on the reference's
invariant with a trace of the same length, each checker run on the other
package's spec objects, the spec constants and epoch rules held to the
port's code, the CLI, and ``--conformance`` over a gloo job's directory.
"""

import base64
import json
import shutil
import zlib

import pytest

import torch_dist_cases as cases
from horovod_tpu.verify import MUTANTS as REF_MUTANTS
from horovod_tpu.verify import SPECS as REF_SPECS
from horovod_tpu.verify import check as ref_check
from horovod_tpu.verify import engine_constants as ref_constants
from horovod_tpu.verify import make_spec as ref_make_spec
from horovod_tpu_torch.common import journal, kv_keys
from horovod_tpu_torch.verify import (MUTANTS, SPECS, CheckResult, Invariant,
                                      Spec, Violation, check, conformance,
                                      engine_constants, make_spec, rules)
from horovod_tpu_torch.verify.cli import CI_DEPTH, CI_MAX_STATES
from horovod_tpu_torch.verify.cli import main as check_main

# (states, transitions, depth) of the port's specs at the CI bound
PORT_COUNTS = {
    "autoscale": (12809, 42740, 31),
    "cycle": (238, 330, 8),
    "drain": (97, 175, 10),
    "epoch": (234, 588, 9),
    "journal": (1027, 1670, 9),
    "paged_cache": (178, 590, 16),
    "replica": (1742, 3222, 9),
    "scrape": (1457, 4566, 11),
    "tune": (6, 9, 3),
}
# ROADMAP C26: a rank that aborted its process groups submits nothing
# more, so the reference's enqueues after an abort request are not
# transitions of the port's cycle spec (they reach no state that
# enqueue-then-abort does not)
DIFFERENT_TRANSITIONS = {"cycle": 362}
# ROADMAP C26: the port's TunedParams carries no routing knobs; its
# hazard of the same class is a threshold seeded from a rank's own env
REF_MUTANT = {"tune_env_divergent_thresholds": "tune_env_divergent_routing"}
REF_INVARIANT = {"thresholds_agree_between_rounds":
                 "routing_agrees_between_cycles"}


def _counts(res):
    return res.states, res.transitions, res.depth_reached


def _summary(res):
    return (_counts(res), res.truncated,
            [(v.invariant, len(v.trace)) for v in res.violations])


@pytest.fixture(scope="module")
def reference_results():
    return {name: ref_check(ref_make_spec(name), depth=CI_DEPTH,
                            max_states=CI_MAX_STATES)
            for name in REF_SPECS}


def test_exports_and_registries():
    assert {Spec, Invariant, CheckResult, Violation} and callable(check)
    assert sorted(SPECS) == sorted(REF_SPECS) == sorted(PORT_COUNTS)
    assert len(MUTANTS) == len(REF_MUTANTS) == 24
    assert sorted(REF_MUTANT.get(m, m) for m in MUTANTS) == \
        sorted(REF_MUTANTS)


# ---------------------------------------------------------------------------
# every spec: exhaustive and clean, with the reference's counts


@pytest.mark.parametrize("spec_name", sorted(PORT_COUNTS))
def test_spec_exhaustive_clean_with_reference_counts(spec_name,
                                                     reference_results):
    res = check(make_spec(spec_name), depth=CI_DEPTH,
                max_states=CI_MAX_STATES)
    assert res.violations == [], res.violations[0].render()
    assert not res.truncated, f"{spec_name} no longer closes at CI depth"
    assert _counts(res) == PORT_COUNTS[spec_name]
    ref = reference_results[spec_name]
    assert ref.ok and not ref.truncated
    states, transitions, depth = _counts(ref)
    assert (states, DIFFERENT_TRANSITIONS.get(spec_name, transitions),
            depth) == (res.states, DIFFERENT_TRANSITIONS.get(
                spec_name, res.transitions), res.depth_reached)
    if spec_name in DIFFERENT_TRANSITIONS:
        assert transitions == DIFFERENT_TRANSITIONS[spec_name]


# ---------------------------------------------------------------------------
# every mutant: a counterexample on the reference's invariant, same length


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_mutant_caught_like_reference(mutant):
    spec_name = MUTANTS[mutant][0]
    res = check(make_spec(spec_name, mutant=mutant), depth=CI_DEPTH,
                max_states=CI_MAX_STATES)
    assert res.violations, f"seeded bug {mutant} was not caught"
    v = res.violations[0]
    rendered = v.render()
    assert "INVARIANT VIOLATED" in rendered and " 1. " in rendered
    ref_name = REF_MUTANT.get(mutant, mutant)
    ref = ref_check(ref_make_spec(REF_MUTANTS[ref_name][0], mutant=ref_name),
                    depth=CI_DEPTH, max_states=CI_MAX_STATES)
    rv = ref.violations[0]
    assert REF_INVARIANT.get(v.invariant, v.invariant) == rv.invariant
    assert len(v.trace) == len(rv.trace), (v.trace, rv.trace)


# ---------------------------------------------------------------------------
# each checker over the other package's spec objects


@pytest.mark.parametrize("spec_name", sorted(PORT_COUNTS))
def test_checkers_agree_on_each_others_specs(spec_name, reference_results):
    port_on_ref = check(ref_make_spec(spec_name), depth=CI_DEPTH,
                        max_states=CI_MAX_STATES)
    assert _summary(port_on_ref) == _summary(reference_results[spec_name])
    port_spec = make_spec(spec_name)
    ref_on_port = ref_check(port_spec, depth=CI_DEPTH,
                            max_states=CI_MAX_STATES)
    assert _summary(ref_on_port) == _summary(
        check(port_spec, depth=CI_DEPTH, max_states=CI_MAX_STATES))


@pytest.mark.parametrize("mutant", ["epoch_accept_stale_notify",
                                    "cycle_abort_ignored",
                                    "replica_stale_lease_accepts_write"])
def test_checkers_agree_on_mutants(mutant):
    """The same counterexample (invariant, trace and final state) from
    either checker, over either package's mutant."""
    for spec in (make_spec(MUTANTS[mutant][0], mutant=mutant),
                 ref_make_spec(REF_MUTANTS[mutant][0], mutant=mutant)):
        a = check(spec, depth=CI_DEPTH)
        b = ref_check(spec, depth=CI_DEPTH)
        assert _summary(a) == _summary(b)
        assert a.violations[0].trace == b.violations[0].trace
        assert a.violations[0].state == b.violations[0].state


def test_all_violations_mode_collects_more():
    spec = make_spec("drain", mutant="drain_scan_after_refresh")
    one = check(spec, depth=CI_DEPTH, max_violations=1)
    every = check(spec, depth=CI_DEPTH, max_violations=0)
    assert len(one.violations) == 1 < len(every.violations)


# ---------------------------------------------------------------------------
# spec constants and rules against the port's code


def test_low_latency_threshold_equals_reference_parse():
    assert engine_constants.low_latency_threshold_default() == \
        ref_constants.low_latency_threshold_default() == 4096


def test_epoch_rule_agrees_with_port_kv_server():
    """rules.admit_epoch IS the port's KVServer._check_epoch_locked —
    proven on the live server."""
    from horovod_tpu_torch.runner.http_kv import KVServer, StaleEpochError
    for current in (0, 1, 3):
        for claimed in (None, 0, 1, 2, 3, 5):
            srv = KVServer(port=0)
            try:
                srv.epoch = current
                outcome, new_epoch = rules.admit_epoch(current, claimed)
                try:
                    srv._put(kv_keys.notify(), b"{}", epoch=claimed)
                    real = rules.ADOPT if srv.epoch > current else rules.OK
                except StaleEpochError:
                    real = rules.FENCED
                assert real == outcome, (current, claimed)
                assert srv.epoch == new_epoch, (current, claimed)
            finally:
                srv._httpd.server_close()


def test_worker_floor_agrees_with_port_observe_epoch(monkeypatch):
    from horovod_tpu_torch.runner.elastic import worker
    monkeypatch.setenv("HOROVOD_CONTROL_EPOCH", "2")
    try:
        for offered in (None, 0, 1, 2, 3):
            worker._reset_epoch_for_tests()
            accepted, floor = rules.worker_accepts(2, offered)
            assert worker.observe_epoch(offered) == accepted, offered
            if accepted and offered is not None:
                assert worker._epoch_floor == floor
    finally:
        worker._reset_epoch_for_tests()


def test_specs_read_the_port_registry(monkeypatch):
    """A changed default in the port's REGISTRY reaches the specs: the
    autoscaler's hysteresis and the express threshold."""
    from horovod_tpu_torch.common import env
    monkeypatch.setitem(env.REGISTRY, "HOROVOD_AUTOSCALE_UP_WINDOWS",
                        (3, "test"))
    monkeypatch.setitem(env.REGISTRY, "HOROVOD_LOW_LATENCY_THRESHOLD",
                        (0, "test"))
    assert make_spec("autoscale").hyst == 3
    assert make_spec("cycle").threshold == 0


def _express_units(monkeypatch, req, rule=None):
    """The launch units the eager plane's ``_batches`` makes of one bulk
    allreduce followed by ``req``, in serving mode on two ranks."""
    from horovod_tpu_torch.common import eager
    from horovod_tpu_torch.common.parameter_manager import TunedParams
    if rule is not None:
        monkeypatch.setattr(rules, "express_eligible", rule)
    ex = object.__new__(eager.EagerExecutor)
    ex.serving_mode = True
    ex._params = TunedParams(low_latency_threshold_bytes=64)
    ex._c_express = type("Counter", (), {"inc": lambda self, n: None})()
    bulk = eager.Request("bulk", eager.ALLREDUCE, "float32", (1024,))
    ready = [(r.name, {0: r, 1: r}) for r in (bulk, req)]
    return [[name for name, _, _ in unit] for unit in ex._batches(ready)]


@pytest.mark.parametrize("op,shape,group", [
    ("allreduce", (16,), -1),    # 64 bytes: at the threshold
    ("allreduce", (17,), -1),    # 68 bytes: over it
    ("allreduce", (4,), 0),      # grouped
    ("barrier", (), -1),         # not data-bearing
    ("broadcast", (8,), -1),
])
def test_eager_express_lane_decides_by_the_spec_rule(monkeypatch, op, shape,
                                                     group):
    """The eager plane peels a request onto the express lane exactly when
    ``rules.express_eligible``, the rule the cycle spec checks, says so,
    and it asks that rule: a changed rule changes the launch order."""
    from horovod_tpu_torch.common import eager
    req = eager.Request("small", op, "float32", shape, group_id=group,
                        group_size=1 if group >= 0 else 0)
    eligible = rules.express_eligible(
        eager._nbytes(req), 64, grouped=group >= 0,
        data_bearing=op != eager.BARRIER)
    got = _express_units(monkeypatch, req)
    assert (got[0] == ["small"]) == eligible, got
    flipped = _express_units(  # flipped for the small request alone
        monkeypatch, req,
        rule=lambda size, *a, **k: size < 4096 and not eligible)
    assert (flipped[0] == ["small"]) == (not eligible), flipped


# ---------------------------------------------------------------------------
# CLI


def test_cli_all_specs_clean_exit_zero(capsys):
    assert check_main([]) == 0
    out = capsys.readouterr().out
    assert out.count("(exhaustive)") == len(SPECS)


def test_cli_mutant_exits_one_and_prints_numbered_trace(capsys):
    assert check_main(["--mutant", "epoch_accept_stale_notify"]) == 1
    out = capsys.readouterr().out
    assert "INVARIANT VIOLATED: worker_generation_monotonic" in out
    assert "     1. " in out and "reproduced" in out


def test_cli_lists_json_and_usage_error(capsys):
    assert check_main(["--list-specs"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert sorted(line.split()[0] for line in listed) == sorted(SPECS)
    assert check_main(["--list-mutants"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert sorted(line.split()[0] for line in listed) == sorted(MUTANTS)
    assert check_main(["--spec", "tune", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["results"][0]["spec"] == "tune"
    assert doc["results"][0]["exhaustive"] is True
    with pytest.raises(SystemExit) as exc:
        check_main(["--spec", "no_such_spec"])
    assert exc.value.code == 2


# ---------------------------------------------------------------------------
# --conformance over a gloo job of the port


def _append_wal_record(kv_dir, op: dict):
    payload = json.dumps(op).encode()
    with open(kv_dir / "wal.log", "ab") as f:
        f.write(len(payload).to_bytes(4, "little") +
                (zlib.crc32(payload) & 0xFFFFFFFF).to_bytes(4, "little") +
                payload)


@pytest.fixture(scope="module")
def job_dir(tmp_path_factory):
    """A job directory as a launch leaves it: the flight dumps of a
    two-rank gloo job of the port, the KV WAL of the port's KVServer
    driven as a driver drives it, and the driver's journal."""
    from horovod_tpu_torch.runner.http_kv import KVServer
    root = tmp_path_factory.mktemp("job")
    run = cases.spawn_flight(2, root / "run")
    assert run["exitcodes"] == [0, 0], run
    shutil.copytree(run["clean"], root / "flight")
    shutil.rmtree(root / "run")
    kv = KVServer(port=0, kv_dir=str(root / "kv"))
    try:
        epoch = kv.epoch
        for slot in (0, 1):
            kv.put_json(kv_keys.rank_and_size(0, "localhost", slot),
                        {"rank": slot, "size": 2, "epoch": epoch},
                        epoch=epoch)
        kv.put_json(kv_keys.generation(), {"generation": 0, "epoch": epoch},
                    epoch=epoch)
        kv.put_json(kv_keys.go(0), {"ts": 1.0, "epoch": epoch}, epoch=epoch)
        kv.put_json(kv_keys.worker_heartbeat("localhost", 0), {"ts": 1.0})
    finally:
        kv._httpd.server_close()
        kv._wal.close()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOROVOD_JOURNAL_DIR", str(root / "journal"))
        journal._reset_for_tests()
        try:
            journal.emit("driver", "resize", control_epoch=epoch,
                         generation=0, slots=2)
        finally:
            journal._reset_for_tests()
    return root, epoch


def test_cli_conformance_over_a_gloo_job(job_dir, capsys):
    root, _ = job_dir
    assert check_main(["--conformance", str(root), "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["divergences"] == []
    kinds = sorted(c.split(":")[0] for c in report["checked"])
    assert kinds == ["flight", "journal", "kv-wal"]
    assert all(n > 0 for n in report["records"].values()), report


def test_cli_conformance_flags_an_epoch_regression(job_dir, tmp_path,
                                                   capsys):
    root, epoch = job_dir
    copy = tmp_path / "job"
    shutil.copytree(root, copy)
    _append_wal_record(copy / "kv", {
        "op": "put", "k": kv_keys.notify(),
        "v": base64.b64encode(json.dumps({"generation": 0}).encode())
        .decode(), "e": epoch - 1})
    assert check_main(["--conformance", str(copy)]) == 1
    out = capsys.readouterr().out
    assert "DIVERGENCE" in out and "split-brain" in out
    assert conformance.check_artifacts(root)["divergences"] == []
