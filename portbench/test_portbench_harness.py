"""CPU tests of the benchmark's harness (``python -m pytest portbench``).

Tiny cells run end to end through the harness's own code path on the CPU
(the program's plain kernels, gloo between ranks) in a copy of the harness
with tiny configurations and cells added; the faults a training cell can
have are planted in the program underneath a run, through a
``sitecustomize`` that only these tests write, and each has to turn
``correct`` false.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

TINY_GPT = dict(name="tiny-gpt", n_layer=2, n_embd=64, n_head=2,
                vocab_size=128, n_positions=32, n_ctx=32)
TINY_BERT = dict(name="tiny-bert", num_hidden_layers=2, hidden_size=64,
                 num_attention_heads=2, vocab_size=128,
                 max_position_embeddings=32, intermediate_size=128)
# readings of these cells at these seeds on the CPU, where the program
# computes in bf16: loss 6e-4 to 1.5e-3, gradient 3e-3 to 5e-3, change
# 8e-3 to 1.3e-2; the fp8 control reads 5e-3 to 1e-2 and 0.03 to 0.06
TINY_LIMITS = {"loss_gap": 3e-3, "grad_gap": 0.02, "delta_gap": 0.05}
TINY_CELLS = (("tiny-gpt-c1", "tiny-gpt", 1), ("tiny-bert-c1", "tiny-bert", 1),
              ("tiny-gpt-dp2", "tiny-gpt", 2))
SEED = 2 ** 31 + 11  # more than 32 signed bits hold

# planted underneath a run by a sitecustomize module these tests write
SITECUSTOMIZE = '''
import os
fault = os.environ.get("PORTBENCH_TEST_FAULT")
if fault == "load_forbidden":
    import sys, types
    sys.modules["horovod_tpu"] = types.ModuleType("horovod_tpu")
elif fault == "load_forbidden_late":
    # loaded after the window, in the last rank's shutdown()
    import sys, types
    import horovod_tpu_torch as hvd
    shutdown = hvd.shutdown

    def late():
        last = hvd.rank() == hvd.size() - 1
        shutdown()
        if last:
            sys.modules["horovod_tpu"] = types.ModuleType("horovod_tpu")
    hvd.shutdown = late
elif fault:
    import torch
    from horovod_tpu_torch.parallel import collectives, dp
    make = dp.make_train_step

    def planted(model, loss_fn, opt, **kw):
        if fault == "half_batch":
            def half(m, b):
                cut = lambda x: x[: x.shape[0] // 2]
                b = cut(b) if torch.is_tensor(b) else \\
                    {k: cut(v) for k, v in b.items()}
                return loss_fn(m, b)
            return make(model, half, opt, **kw)
        step = make(model, loss_fn, opt, **kw)
        if fault != "unchanged":
            return step

        def unchanged(batch, *a, **k):
            before = [p.detach().clone() for p in model.parameters()]
            out = step(batch, *a, **k)
            with torch.no_grad():
                for p, b in zip(model.parameters(), before):
                    p.copy_(b)
            return out
        return unchanged
    dp.make_train_step = planted
    if fault == "no_exchange":
        dp._replicated_reduce = lambda *a: (
            lambda unit, grads: collectives.Pending([], lambda: grads))
'''


def copy_harness(dest: Path) -> Path:
    """A copy of the committed harness: ``portbench/`` and
    ``BENCHMARK.json``."""
    shutil.copytree(HERE, dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def add_tiny_cells(root: Path) -> None:
    """Tiny configurations and cells added to the copy at ``root``, as a
    later change adds its own: new files and new entries only."""
    pb = root / "portbench"
    for base, tiny in (("gpt2-small", TINY_GPT), ("bert-large", TINY_BERT)):
        cfg = json.loads((pb / "configs" / f"{base}.json").read_text())
        cfg.update(tiny)
        (pb / "configs" / f"{tiny['name']}.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, config, chips in TINY_CELLS:
        (pb / "workloads" / f"{name}.json").write_text(json.dumps(
            {"name": name, "batch_per_rank": 4, "seq_len": 32,
             "distinct_batches": 8, "limits": TINY_LIMITS}))
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": name, "chips": chips,
                                   "why": "tiny, for the CPU tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = copy_harness(tmp_path_factory.mktemp("tree"))
    add_tiny_cells(root)
    site = root / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    return root


def run_cpu(root: Path, workload: str, fault: str = "", trace: int = 0,
            timeout: float = 240.0):
    """``portbench.run.run`` of ``workload`` on the CPU in a process of its
    own, from the copy at ``root``. Returns (exit code, the last line of
    standard output parsed, standard error)."""
    env = dict(os.environ, PYTHONPATH=f"{root / 'site'}{os.pathsep}{REPO}",
               OMP_NUM_THREADS="2", PORTBENCH_TEST_FAULT=fault,
               HOROVOD_FLASH_MIN_SEQ="16")  # the flash route at T 32
    code = ("import sys; from portbench.run import run; "
            f"sys.exit(run({workload!r}, {SEED}, 0.5, {bool(trace)}, "
            "device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and proc.returncode == 0 else None
    return proc.returncode, last, proc.stderr


@pytest.mark.parametrize("workload", [c[0] for c in TINY_CELLS])
def test_tiny_cell_end_to_end(tiny_root, workload):
    rc, line, err = run_cpu(tiny_root, workload)
    assert rc == 0, err[-3000:]
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 10
    assert set(line["metrics"]) == {"train_samples_per_s", "step_ms_p90",
                                    "peak_mem_gib", "setup_s"}
    assert all(m["value"] > 0 or name == "peak_mem_gib"
               for name, m in line["metrics"].items())
    assert line["device"]["count"] == (2 if "dp2" in workload else 1)
    # every number compared ends standard error beside its limit
    tail = err.strip().splitlines()[-3:]
    assert [t.split()[0] for t in tail] == list(line["checks"])
    assert all("limit" in t for t in tail)


def test_tiny_cell_traced(tiny_root):
    rc, line, err = run_cpu(tiny_root, "tiny-gpt-c1", trace=1)
    assert rc == 0, err[-3000:]
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["correct"] is True
    # no device ran: nothing to read, and no metric reported as 0
    assert line["metrics"] == {}
    assert line["breakdown"] == {"device_ops": [], "idle_gaps": []}


@pytest.mark.parametrize("workload,fault,number", [
    ("tiny-gpt-c1", "unchanged", "delta_gap"),
    ("tiny-bert-c1", "unchanged", "delta_gap"),
    ("tiny-gpt-c1", "half_batch", "grad_gap"),
    ("tiny-bert-c1", "half_batch", "grad_gap"),
    ("tiny-gpt-dp2", "no_exchange", "grad_gap"),
])
def test_planted_fault_fails(tiny_root, workload, fault, number):
    rc, line, err = run_cpu(tiny_root, workload, fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
    check = line["checks"][number]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("workload,fault", [
    ("tiny-gpt-c1", "load_forbidden"),
    ("tiny-gpt-c1", "load_forbidden_late"),
    ("tiny-gpt-dp2", "load_forbidden_late"),
])
def test_forbidden_module_refuses_the_run(tiny_root, workload, fault):
    """A forbidden module loaded in any rank, at start-up or after the
    window, refuses the run."""
    rc, line, err = run_cpu(tiny_root, workload, fault)
    assert rc != 0 and line is None
    assert "horovod_tpu" in err.strip().splitlines()[-1]


def test_control_fails_the_limits(tiny_root):
    """The fp8 control, the half batch and the missing exchange, read
    against the reference at the tiny cells' size, each fail a number."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.control", "--workload",
         "tiny-gpt-dp2", "--seeds", f"{SEED},7", "--device", "cpu"],
        cwd=tiny_root, env=env, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(x) for x in out.stdout.splitlines()]
    assert {r["variant"] for r in rows} == {"control", "half_batch",
                                            "no_exchange"}
    for r in rows:
        assert any(r[k] > TINY_LIMITS[k] for k in TINY_LIMITS), r


def test_refuses_without_the_cards(tmp_path):
    """No result without as many CUDA cards as the cell asks for."""
    root = copy_harness(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "gpt2s-t1024-b32", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=root, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_refuses_outside_the_repository(tmp_path):
    """A directory with only BENCHMARK.json and the harness cannot run."""
    root = copy_harness(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "gpt2s-t1024-b32", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=root, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tiny_root):
    """The tiny GPT cell through the card's own path (the flash kernels)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = dict(os.environ, PYTHONPATH=str(REPO), HOROVOD_FLASH_MIN_SEQ="16")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "tiny-gpt-c1",
         "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
        cwd=tiny_root, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["launches_per_step"]["value"] > 0
