"""One cell of the benchmark: its files found by name, and one rank's run.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its configuration
is ``configs/<config>.json``, its traffic ``workloads/<traffic>.json``, its
model family ``models/<family>.py`` (named in the configuration's file), and
each per-layer metric that applies to it ``metrics/<metric>.py``. Nothing
here names a cell, a configuration or a metric.

One rank's run (``run_rank``), in order:

1. set-up: ``init()``, the program's model built at the configuration's
   widths with weights drawn from the seed, AdamW, ``make_train_step``, and
   a pool of distinct batches drawn from the seed on the device;
2. three checked steps through the window's own call and feed (their
   losses, the first gradient as AdamW's state holds it, and every leaf's
   change after the third are kept for the comparison), then two more that
   size the window and warm it;
3. the window: a fixed number of steps, agreed by all ranks, that fills
   about ``--seconds``, bounded by a synchronize at each end; a CUDA event
   on the compute stream at each step's start times every step;
4. with ``--trace 1``, a few more steps under ``torch.profiler``;
5. the program's state freed and ``shutdown()``; then, on rank 0, the
   plain reference over the same weights and batches, and the numbers that
   decide ``correct``.
"""

from __future__ import annotations

import gc
import importlib.util
import itertools
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "horovod_tpu")

CHECKED_STEPS = 3   # compared with the reference
SIZING_STEPS = 2    # time the step to size the window
TRACED_STEPS = 5    # under the profiler, after one step of its warm-up
MIN_WINDOW_STEPS = 10


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN``."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def load_family(name: str, here: Path = HERE) -> ModuleType:
    return _load_module(here / "models" / f"{name}.py",
                        f"portbench.models.{name}")


def load_reader(metric: str, here: Path = HERE) -> ModuleType:
    return _load_module(here / "metrics" / f"{metric}.py",
                        "portbench.metrics." + metric.replace(".", "_"))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    family: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, ModuleType] = field(default_factory=dict)


def applies(metric: dict, cell: str, reported: List[str]) -> bool:
    """Whether a metric belongs to ``cell``: listed in its ``workloads``,
    or without that key, in every cell that reports the end-to-end metric
    it ``moves`` (an end-to-end metric moves none: in every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def workload_entry(name: str, root: Path = ROOT) -> dict:
    """The cell's entry in ``workloads``."""
    found = [w for w in load_benchmark(root)["workloads"]
             if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    return found[0]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = load_benchmark(root)
    entry = workload_entry(name, root)
    config = _load_json(here / "configs" / f"{entry['config']}.json")
    traffic = _load_json(here / "workloads" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if applies(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if applies(m, name, names)]
    return Cell(name, entry["chips"], config, traffic,
                load_family(config["family"], here), e2e, per_layer,
                {m["name"]: load_reader(m["name"], here) for m in per_layer})


# --------------------------------------------------------------------------
# one rank's run


@dataclass
class Context:
    """What a per-layer metric's reader reads (rank 0's run)."""
    config: dict
    traffic: dict
    shape: dict
    step_flops: int        # model FLOPs of one rank's step
    card: str
    window_steps: int
    window_s: float
    trace: object = None   # devtrace.Trace of the traced steps
    traced_steps: int = 0
    flash_launches: Dict[str, int] = field(default_factory=dict)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Marks:
    """Step boundaries: CUDA events on the compute stream, or the host's
    clock without a card."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        import torch
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [m[i].elapsed_time(m[i + 1]) for i in range(len(m) - 1)]
        return [(m[i + 1] - m[i]) * 1e3 for i in range(len(m) - 1)]


def _norms(tensors) -> List[float]:
    import torch
    return [float(x) for x in torch.stack(list(tensors)).cpu()]


def _trace_steps(step, batches, device, tmpdir) -> tuple:
    """TRACED_STEPS steps under the profiler after one step of its warm-up.
    Returns (the trace, the flash launches of the traced steps)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from horovod_tpu_torch.ops import flash_attention as fa
    from portbench import devtrace
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json",
                                dir=tmpdir)
    os.close(fd)
    try:
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1,
                                       active=TRACED_STEPS),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            before = None
            for i in range(TRACED_STEPS + 1):
                if i == 1:
                    before = fa.launch_counts()
                step(batches[i % len(batches)])
                if i == TRACED_STEPS:
                    _sync(device)
                prof.step()
        after = fa.launch_counts()
        trace = devtrace.load(path)
    finally:
        os.unlink(path)
    return trace, {k: after[k] - before[k] for k in after}


def _program(cell: Cell, seed: int, seconds: float, trace: bool,
             card: str, tmpdir: Optional[str]) -> dict:
    """Set-up, checked steps, window and trace of the program on this
    rank. Returns this rank's readings."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import dp
    from portbench import data, devtrace
    fam, cfg, tr = cell.family, cell.config, cell.traffic
    dev, rank, world = hvd.device(), hvd.rank(), hvd.size()
    rows, seq = tr["batch_per_rank"], tr["seq_len"]
    vocab = fam.shape(cfg)["vocab"]
    spec = fam.leaf_spec(cfg)

    phases = {"init": time.time()}
    model, loss_fn = fam.program(cfg, dev)
    named = list(model.named_parameters())
    got = {n: tuple(p.shape) for n, p in named}
    want = {n: tuple(s) for n, s, _ in spec}
    if got != want:
        raise ValueError(f"the program's parameters {sorted(got)} are not "
                         f"the reference's {sorted(want)}")
    w0 = data.make_weights(spec, seed, dev)
    with torch.no_grad():
        for n, p in named:
            p.copy_(w0[n])
    del w0
    phases["weights"] = time.time()
    o = cfg["run"]["optimizer"]
    opt = torch.optim.AdamW(model.parameters(), lr=o["lr"],
                            betas=tuple(o["betas"]), eps=o["eps"],
                            weight_decay=o["weight_decay"])
    step = dp.make_train_step(
        model, loss_fn, opt,
        compression=getattr(hvd.Compression, cfg["run"]["compression"]),
        bucket_bytes=cfg["run"]["bucket_bytes"], device=dev)
    pool = [fam.program_batch(*data.make_ids(seed, rank, i, rows, seq,
                                             vocab, dev))
            for i in range(tr["distinct_batches"])]
    feed = itertools.count()

    def batch():
        return pool[next(feed) % len(pool)]

    # the checked steps: what the reference is compared on
    losses = []
    for i in range(CHECKED_STEPS):
        out = step(batch())
        losses.append(out.loss.detach().float())
        if i == 0:
            phases["first_step"] = time.time()
            b1 = o["betas"][0]
            grad1 = _norms(opt.state[p]["exp_avg"].double().norm() / (1 - b1)
                           for _, p in named)
    w0 = data.make_weights(spec, seed, dev)
    delta = _norms((p.detach() - w0[n]).double().norm() for n, p in named)
    del w0
    phases["checked_steps"] = time.time()
    readings = {"losses": [float(x) for x in losses],
                "grad1": dict(zip((n for n, _ in named), grad1)),
                "delta": dict(zip((n for n, _ in named), delta))}

    # size the window: all ranks run the same number of steps
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(SIZING_STEPS):
        step(batch())
    _sync(dev)
    per_step = (time.perf_counter() - t0) / SIZING_STEPS
    n_steps = max(MIN_WINDOW_STEPS, math.ceil(seconds / per_step))
    if world > 1:
        n_steps = hvd.broadcast_object(n_steps, root_rank=0)

    # the window
    marks = _Marks(dev)
    window_losses = []
    _sync(dev)
    window_wall = time.time()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        marks.mark()
        window_losses.append(step(batch()).loss.detach())
    marks.mark()
    _sync(dev)
    window_s = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(window_losses).float())).sum())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    phases["sizing_steps"] = window_wall
    res = {"rank": rank, "world": world, "window_wall": window_wall,
           "phases": phases,
           "window_s": window_s, "steps": n_steps,
           "step_ms": marks.intervals_ms(), "failed": failed,
           "memory_peak_bytes": peak, "readings": readings,
           "forbidden": forbidden_modules()}

    if trace:
        tr_obj, launches = _trace_steps(step, pool, dev, tmpdir)
        busy_us, win_us = devtrace.busy_idle_us(tr_obj)
        res.update(busy_s=busy_us / 1e6, trace_window_s=win_us / 1e6)
        if rank == 0:
            ctx = Context(cfg, tr, fam.shape(cfg), fam.step_flops(cfg, tr),
                          card, n_steps, window_s, tr_obj, TRACED_STEPS,
                          launches)
            res["per_layer"] = {
                name: reader.read(ctx)
                for name, reader in cell.readers.items()}
            res["breakdown"] = {"device_ops": devtrace.top_ops(tr_obj),
                                "idle_gaps": devtrace.idle_gaps(tr_obj)}
    del step, opt, model, pool, out, named
    return res


def reference_readings(cell: Cell, seed: int, world: int, device,
                       matmul: str = "float32",
                       fault: Optional[str] = None) -> dict:
    """The plain reference trained from the same weights through the same
    batches as the checked steps: every replica's batch of each step."""
    import torch

    from portbench import data, reference
    fam, cfg, tr = cell.family, cell.config, cell.traffic
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    vocab = fam.shape(cfg)["vocab"]
    w0 = data.make_weights(fam.leaf_spec(cfg), seed, device)
    steps = [[data.make_ids(seed, r, i % tr["distinct_batches"],
                            tr["batch_per_rank"], tr["seq_len"], vocab,
                            device) for r in range(world)]
             for i in range(CHECKED_STEPS)]
    return reference.run_steps(w0, steps, fam.Reference(cfg),
                               cfg["run"]["optimizer"],
                               mm=reference.MATMULS[matmul], fault=fault)


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool,
             card: str, device: Optional[str] = None,
             tmpdir: Optional[str] = None) -> dict:
    """One rank's run (the module's docstring). Rank 0's result carries
    the numbers that decide ``correct`` under ``checks``."""
    import torch

    import horovod_tpu_torch as hvd
    from portbench import reference
    hvd.init(device=device)
    try:
        dev = hvd.device()
        res = _program(cell, seed, seconds, trace, card, tmpdir)
    finally:
        hvd.shutdown()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if res["rank"] == 0:
        t0 = time.perf_counter()
        want = reference_readings(cell, seed, res["world"], dev)
        res["reference_s"] = time.perf_counter() - t0
        gaps = reference.gaps(res.pop("readings"), want)
        limits = cell.traffic["limits"]
        res["checks"] = {k: {"value": v, "limit": limits[k]}
                         for k, v in gaps.items()}
    else:
        res.pop("readings")
    # again at the end: what the traced steps, the reference or shutdown()
    # loaded counts too
    res["forbidden"] = sorted(set(res["forbidden"]) | set(forbidden_modules()))
    return res
