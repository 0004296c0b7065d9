"""The port's benchmark: one run of one cell.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. A cell on one card runs in this process; a cell on more runs
one rank a card under the port's static launcher
(``horovod_tpu_torch.runner.launch``), each rank ``python -m
portbench.worker``, and this process gathers their results.

Standard output: a line with the card's name and power limit and the peak
the utilization is taken against, then, last, one JSON object: ``correct``,
``attempted`` and ``failed`` (window steps, and those whose loss was not
finite), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number that decides ``correct`` beside its limit. The same
numbers end standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from typing import List, Optional


def process_start_wall() -> float:
    """This process's start on the wall clock (to 10 ms): its age from
    ``/proc``, taken from now."""
    now = time.time()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


_START = process_start_wall()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel caches of the program's libraries, at fixed paths in the checkout
# (``build/`` beside the port's own kernel builds): PyTorch's runtime-
# compiled kernels and the CUDA driver's JIT cache
CACHES = {"PYTORCH_KERNEL_CACHE_PATH": "build/portbench/torch_kernels",
          "CUDA_CACHE_PATH": "build/portbench/cuda_cache"}
# a multi-card run's word to its ranks that the cards are there and the
# kernels built, with the card's name
GO_FILE = "go.json"


def card_name_and_limit(device: str) -> tuple:
    """(the name CUDA gives card 0, its power limit as ``nvidia-smi`` reads
    it); on the CPU ("cpu", "none")."""
    if device == "cpu":
        return "cpu", "none"
    import torch
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=60)
        limit = out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "unknown"
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return name, limit


class Ranks:
    """One rank a card under the port's static launcher on this host,
    started before this process imports anything heavy: the launcher and
    the ranks import the program while this process checks the cards and
    builds the kernels. Each rank then waits for ``go()`` before it
    starts its run."""

    def __init__(self, workload: str, chips: int, seed: int,
                 seconds: float, trace: bool, device: Optional[str]):
        self.chips = chips
        self.out_dir = tempfile.mkdtemp(prefix="portbench-ranks-")
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", str(chips), "-H", f"localhost:{chips}", "--",
               sys.executable, "-m", "portbench.worker", "--workload",
               workload, "--seed", str(seed), "--seconds", str(seconds),
               "--trace", str(int(trace)), "--out", self.out_dir,
               "--parent", str(os.getpid())]
        if device is not None:
            cmd += ["--device", device]
        # the launcher's group holds every rank: stop() ends them all
        self.proc = subprocess.Popen(cmd, cwd=ROOT, stdout=sys.stderr,
                                     start_new_session=True)

    def go(self, card: str) -> None:
        path = os.path.join(self.out_dir, GO_FILE)
        with open(path + ".tmp", "w") as f:
            json.dump({"card": card}, f)
        os.replace(path + ".tmp", path)

    def results(self, timeout: float = 1150.0) -> List[dict]:
        """Every rank's result, rank 0 first."""
        rc = self.proc.wait(timeout=timeout)
        if rc != 0:
            raise RuntimeError(f"the launcher exited with {rc}")
        results = []
        for r in range(self.chips):
            with open(os.path.join(self.out_dir, f"rank{r}.json")) as f:
                results.append(json.load(f))
        return results

    def stop(self) -> None:
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()
        shutil.rmtree(self.out_dir, ignore_errors=True)


def p90(values: List[float]) -> float:
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def result_line(cell, results: List[dict], trace: bool, card: str,
                start_wall: float, platform: str) -> dict:
    r0 = results[0]
    world = len(results)
    forbidden = sorted({m for r in results for m in r["forbidden"]})
    correct = (not forbidden and all(r["failed"] == 0 for r in results)
               and all(c["value"] <= c["limit"]
                       for c in r0["checks"].values()))
    device = {"platform": platform, "kind": card, "count": world,
              "memory_peak_bytes": max(r["memory_peak_bytes"]
                                       for r in results)}
    if trace:
        metrics = {m["name"]: {"value": r0["per_layer"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.per_layer
                   if r0["per_layer"].get(m["name"]) is not None}
        device["busy_s"] = statistics.fmean(r["busy_s"] for r in results)
        device["window_s"] = statistics.fmean(r["trace_window_s"]
                                              for r in results)
    else:
        samples = r0["steps"] * cell.traffic["batch_per_rank"] * world
        values = {"train_samples_per_s": samples / r0["window_s"],
                  "step_ms_p90": p90(r0["step_ms"]),
                  "peak_mem_gib": device["memory_peak_bytes"] / 2 ** 30,
                  "setup_s": r0["window_wall"] - start_wall}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": correct, "attempted": r0["steps"],
            "failed": sum(r["failed"] for r in results),
            "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = r0["breakdown"]
    line["checks"] = r0["checks"]
    return line, forbidden


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: Optional[str] = None, start_wall: float = _START) -> int:
    """One run; ``device="cpu"`` runs the cell's ranks on the CPU (the
    harness's own tests) instead of one card each."""
    for name, path in CACHES.items():
        os.environ[name] = os.path.join(ROOT, path)
        os.makedirs(os.environ[name], exist_ok=True)
    from portbench.cell import (forbidden_modules, load_cell, run_rank,
                                workload_entry)
    chips = workload_entry(workload)["chips"]
    ranks = Ranks(workload, chips, seed, seconds, trace, device) \
        if chips > 1 else None
    try:
        cell = load_cell(workload)
        if device is None:
            import torch
            if not torch.cuda.is_available() or \
                    torch.cuda.device_count() < chips:
                sys.stderr.write(
                    f"portbench: {workload} needs {chips} CUDA card(s); "
                    f"this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
                return 2
            if ranks is not None:
                # built once here, not by every rank at once
                from horovod_tpu_torch.ops import _build
                _build.build()
        card, limit = card_name_and_limit(device or "cuda")
        from portbench.flops import peak_flops
        print(json.dumps({"card": card, "power_limit": limit,
                          "peak_flops": peak_flops(
                              card, cell.config["run"]["dtype"])}),
              flush=True)
        if ranks is None:
            results = [run_rank(cell, seed, seconds, trace, card, device)]
        else:
            ranks.go(card)
            results = ranks.results()
    finally:
        if ranks is not None:
            ranks.stop()
    line, forbidden = result_line(cell, results, trace, card, start_wall,
                                  "cpu" if device == "cpu" else "gpu")
    forbidden = sorted(set(forbidden) | set(forbidden_modules()))
    if forbidden:
        sys.stderr.write(f"portbench: modules loaded that a run must not "
                         f"load: {', '.join(forbidden)}\n")
        return 3
    for r in results:
        sys.stderr.write(f"setup of rank {r['rank']}, s from the process's "
                         "start: " + json.dumps(
                             {k: v - start_wall
                              for k, v in r["phases"].items()}) + "\n")
    sys.stderr.write(f"reference {results[0]['reference_s']:.3f} s\n")
    for name, c in line["checks"].items():
        sys.stderr.write(f"{name} {c['value']!r} limit {c['limit']!r}\n")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    return run(args.workload, args.seed, args.seconds, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
