"""CPU tests of the yardstick's arithmetic and of the harness's data: the
FLOP count and the kernels' bounds against hand-worked numbers, the idle
share and exposed communication of a synthetic trace, the whole-name check
of loaded modules, every file found by name, a cell, a configuration and a
metric added by files alone, and ``BENCHMARK.json`` against its contract."""

from __future__ import annotations

import json
import re
import sys
import types
from pathlib import Path

import pytest

from portbench import cell as cellmod
from portbench import devtrace, flops
from portbench.metrics import _nccl

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


# --------------------------------------------------------------------------
# FLOPs and bounds


def test_attention_pairs_by_hand():
    assert flops.attention_pairs(4, 4, False) == 16
    assert flops.attention_pairs(4, 4, True) == 1 + 2 + 3 + 4
    # queries at 2, 3 against keys 0-3: 3 and 4 visible
    assert flops.attention_pairs(2, 4, True, q_off=2) == 7
    # every key in the future
    assert flops.attention_pairs(2, 2, True, q_off=0, k_off=8) == 0
    assert flops.attention_pairs(1024, 1024, True) == 1024 * 1025 // 2


def test_forward_flops_by_hand():
    shape = dict(layers=1, hidden=4, heads=2, head_dim=2, v_head_dim=2,
                 mlp=8, vocab=10, causal=True)
    # Dense weights: q, k, v, o 4 x 4 each, MLP 4 x 8 twice; head 10 x 4
    weights = 4 * 16 + 2 * 32 + 40
    # 2 heads x 1 layer x 6 visible pairs (T 3) x 2 (d + dv)
    attn = 2 * 6 * 2 * 4
    assert flops.forward_flops(shape, 1, 3) == 2 * weights * 3 + attn
    assert flops.train_step_flops(shape, 1, 3) == 3 * (2 * weights * 3 +
                                                       attn)


def test_model_flops_of_the_configurations():
    from portbench.models import bert, gpt2
    gpt = json.loads((HERE / "configs/gpt2-small.json").read_text())
    # 12 x (4 x 768^2 + 2 x 768 x 3072) + 50257 x 768 weights
    w = 12 * (4 * 768 ** 2 + 2 * 768 * 3072) + 50257 * 768
    assert w == 123_532_032
    pairs = 1024 * 1025 // 2
    want = 3 * (2 * w * 32 * 1024 + 32 * 12 * 12 * pairs * 2 * 128)
    assert gpt2.step_flops(gpt, {"batch_per_rank": 32, "seq_len": 1024}) \
        == want
    bl = json.loads((HERE / "configs/bert-large.json").read_text())
    per_token = bert.step_flops(bl, {"batch_per_rank": 1, "seq_len": 512}) \
        / 512
    assert per_token == pytest.approx(2.15e9, rel=0.01)


def test_kernel_bounds_by_hand():
    # B 1, T 2, H 1, d 2, causal, bf16: 3 pairs, each [1, 2, 1, 2] tensor
    # 8 bytes, each [1, 1, 2] fp32 row 8 bytes
    got = flops.kernel_bounds(1, 2, 1, 2, True, "bfloat16")
    assert got["flash_fwd"][2:] == (2 * 8 + 8 + 8 + 8, 2 * 3 * 4)
    assert got["flash_bwd_dq"][2:] == (2 * 8 + 16 + 16 + 8, 2 * 3 * 6)
    assert got["flash_bwd_dkv"][2:] == (2 * 8 + 16 + 16 + 8 + 8, 2 * 3 * 8)
    # so small that the bytes bound it
    assert got["flash_fwd"][0] == pytest.approx(40 / 3.35e12 * 1e3)
    assert got["flash_fwd"][1] == "bytes"
    # GPT-2 small per card, 8 x 1024, 12 heads: PERF.md's 0.0151 (bytes),
    # 0.0196 and 0.0261 ms (operations)
    gpt = flops.kernel_bounds(8, 1024, 12, 64, True, "bfloat16")
    assert [round(gpt[k][0], 4) for k in ("flash_fwd", "flash_bwd_dq",
                                          "flash_bwd_dkv")] == \
        [0.0151, 0.0196, 0.0261]
    assert gpt["flash_bwd_dq"][1] == "operations"


def test_peaks_by_card_name():
    assert flops.peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert flops.peak_flops("NVIDIA H100 PCIe", "bfloat16") is None
    assert flops.peak_flops("cpu", "bfloat16") is None


# --------------------------------------------------------------------------
# the trace


def synthetic_trace():
    """Compute kernels on one stream, NCCL on another overlapping them, a
    copy, and a kernel of the step before the traced ones (its launch is not
    in the trace)."""
    def dev(name, ts, dur, corr, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr, "stream": 7}}

    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "args": {"correlation": corr}}
    events = [
        dev("gemm_a", 100, 10, 1), launch(90, 1),
        dev("ncclDevKernel_AllReduce", 105, 15, 2), launch(91, 2),
        dev("Memcpy DtoD", 125, 5, 3, "gpu_memcpy"), launch(92, 3),
        dev("gemm_b", 140, 10, 4), launch(93, 4),
        dev("leftover", 50, 30, 99),  # launched before tracing began
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 131,
         "dur": 8},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 118,
         "dur": 3},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#3",
         "ts": 80, "dur": 100},
    ]
    return devtrace.from_events(events)


def test_idle_share_is_the_union_not_the_sum():
    tr = synthetic_trace()
    assert [op.name for op in tr.device] == [
        "gemm_a", "ncclDevKernel_AllReduce", "Memcpy DtoD", "gemm_b"]
    busy, window = devtrace.busy_idle_us(tr)
    # union [100, 120] + [125, 130] + [140, 150] in the window [100, 150];
    # the sum of durations (40) would put idle at 20%
    assert (busy, window) == (35.0, 50.0)
    from portbench.metrics import device_idle_pct, launches_per_step
    ctx = types.SimpleNamespace(trace=tr, traced_steps=2)
    assert device_idle_pct.read(ctx) == pytest.approx(30.0)
    assert launches_per_step.read(ctx) == 1.5  # 3 kernels, the copy not
    gaps = devtrace.idle_gaps(tr)
    # [130, 140]: aten::mm runs at 135; [120, 125]: none runs, after add
    assert gaps == [["aten::mm", 10e-6], ["after aten::add", 5e-6]]
    assert devtrace.top_ops(tr, 2) == [["ncclDevKernel_AllReduce", 15e-6],
                                       ["gemm_a", 10e-6]]


def test_exposed_and_total_communication():
    from portbench.metrics import comm_ms, exposed_comm_ms
    tr = synthetic_trace()
    nccl, other = _nccl.split(tr)
    assert nccl == [(105.0, 120.0)]
    ctx = types.SimpleNamespace(trace=tr, traced_steps=1)
    assert comm_ms.read(ctx) == pytest.approx(15e-3)
    # NCCL alone from 110 to 120: gemm_a covers 105-110
    assert exposed_comm_ms.read(ctx) == pytest.approx(10e-3)
    none = types.SimpleNamespace(trace=devtrace.Trace([], []),
                                 traced_steps=1)
    assert comm_ms.read(none) is None and exposed_comm_ms.read(none) is None


def test_flash_roofline_needs_the_counted_launches():
    from portbench.metrics import flash_bwd_roofline_pct, \
        flash_fwd_roofline_pct
    kern = [devtrace.Op(f"void hvdflash::{n}_sm90<bf16, 64>", "kernel",
                        t, t + us)
            for n, t, us in (("flash_fwd", 0, 40), ("flash_fwd", 100, 60),
                             ("flash_bwd_dq", 200, 50),
                             ("flash_bwd_dkv", 300, 100))]
    shape = dict(heads=12, head_dim=64, v_head_dim=64, causal=True)
    ctx = types.SimpleNamespace(
        trace=devtrace.Trace(kern, []), shape=shape,
        traffic={"batch_per_rank": 8, "seq_len": 1024},
        config={"run": {"dtype": "bfloat16"}},
        flash_launches={"flash_fwd": 2, "flash_bwd_dq": 1,
                        "flash_bwd_dkv": 1})
    b = flops.kernel_bounds(8, 1024, 12, 64, True, "bfloat16")
    assert flash_fwd_roofline_pct.read(ctx) == pytest.approx(
        100 * b["flash_fwd"][0] / 0.050)
    assert flash_bwd_roofline_pct.read(ctx) == pytest.approx(
        100 * (b["flash_bwd_dq"][0] + b["flash_bwd_dkv"][0]) / 0.150)
    ctx.flash_launches["flash_fwd"] = 3  # the names missed a launch
    assert flash_fwd_roofline_pct.read(ctx) is None
    ctx.flash_launches = {k: 0 for k in ctx.flash_launches}
    ctx.trace = devtrace.Trace([], [])  # the dense route: nothing to read
    assert flash_bwd_roofline_pct.read(ctx) is None


def test_mfu_reads_only_a_known_peak():
    from portbench.metrics import mfu
    ctx = types.SimpleNamespace(card="NVIDIA H100 80GB HBM3",
                                config={"run": {"dtype": "bfloat16"}},
                                step_flops=989e12 * 0.2, window_steps=10,
                                window_s=10.0)
    assert mfu.read(ctx) == pytest.approx(20.0)
    ctx.card = "cpu"
    assert mfu.read(ctx) is None


# --------------------------------------------------------------------------
# modules a run loads


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("horovod_tpu_torch", "horovod_tpu_torch.parallel.dp",
                 "jaxtyping", "flax_like", "horovod_tpux"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert cellmod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "horovod_tpu.ops",
                        types.ModuleType("horovod_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert cellmod.forbidden_modules() == ["horovod_tpu.ops", "jax"]


def test_harness_sources_import_nothing_forbidden():
    """No file of the harness imports the JAX package or JAX, and the
    reference imports nothing of the program."""
    pat = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][\w.]*)", re.M)
    for path in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in pat.findall(path.read_text())}
        assert not tops & set(cellmod.FORBIDDEN), path
    for name in ("reference.py", "data.py", "flops.py"):
        tops = {m.split(".")[0] for m in
                pat.findall((HERE / name).read_text())}
        assert "horovod_tpu_torch" not in tops, name


# --------------------------------------------------------------------------
# files found by name


def test_every_file_is_found():
    configs = {c["name"] for c in BENCH["configs"]}
    traffic = {w["traffic"] for w in BENCH["workloads"]}
    metrics = {m["name"] for m in BENCH["per_layer"]}
    assert {p.stem for p in (HERE / "configs").glob("*.json")} == configs
    assert {p.stem for p in (HERE / "workloads").glob("*.json")} == traffic
    assert {p.stem for p in (HERE / "metrics").glob("*.py")
            if not p.stem.startswith("_")} == metrics
    families = set()
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        families.add(json.loads((REPO / c["file"]).read_text())["family"])
    assert {p.stem for p in (HERE / "models").glob("*.py")
            if not p.stem.startswith("_")} == families
    for w in BENCH["workloads"]:
        cell = cellmod.load_cell(w["name"])
        assert cell.chips == w["chips"]
        assert set(cell.readers) == {m["name"] for m in cell.per_layer}
        assert {m["name"] for m in cell.end_to_end} == \
            {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert callable(cellmod.load_reader(m["name"]).read)


def test_program_parameters_are_the_leaf_spec():
    """Each configuration's program, built on the CPU at its published
    widths, has exactly the leaves its reference is given."""
    import torch
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        fam = cellmod.load_family(cfg["family"])
        model, _ = fam.program(cfg, torch.device("meta"))
        got = {n: tuple(p.shape) for n, p in model.named_parameters()}
        assert got == {n: tuple(s) for n, s, _ in fam.leaf_spec(cfg)}


def test_a_cell_config_and_metric_added_by_files_alone(tmp_path):
    """A later change adds a configuration, a cell and a per-layer metric
    with new files and new entries in BENCHMARK.json; no file of the
    harness changes, and the harness finds all three."""
    from portbench.test_portbench_harness import copy_harness
    root = copy_harness(tmp_path)
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs/gpt2-small.json").read_text())
    cfg.update(name="gpt2-medium", n_layer=24, n_embd=1024, n_head=16)
    (pb / "configs/gpt2-medium.json").write_text(json.dumps(cfg))
    (pb / "workloads/gpt2m-t1024-b16.json").write_text(json.dumps(
        {"name": "gpt2m-t1024-b16", "batch_per_rank": 16, "seq_len": 1024,
         "distinct_batches": 8,
         "limits": {"loss_gap": 1, "grad_gap": 1, "delta_gap": 1}}))
    (pb / "metrics/steps_in_window.py").write_text(
        'def read(ctx):\n    return ctx.window_steps\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gpt2-medium", "source": "x",
                             "file": "portbench/configs/gpt2-medium.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "gpt2m-t1024-b16",
                               "config": "gpt2-medium",
                               "traffic": "gpt2m-t1024-b16", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "train step",
                               "moves": "train_samples_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data, p
    new = cellmod.load_cell("gpt2m-t1024-b16", root=root, here=pb)
    assert new.family.shape(new.config)["layers"] == 24
    assert new.readers["steps_in_window"].read(
        types.SimpleNamespace(window_steps=7)) == 7
    # metrics without a list of cells reach every cell, old ones too
    old = cellmod.load_cell("gpt2s-t1024-b32", root=root, here=pb)
    assert "steps_in_window" in old.readers


# --------------------------------------------------------------------------
# BENCHMARK.json against its contract

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
