#!/usr/bin/env python3
"""Time the flash kernels and the GPT-2-small train step of two checkouts of
this repository on one CUDA card, in turns A, B, B, A.

    python3 compare_trees.py --a PARENT_DIR --b . [--out FILE]
    python3 compare_trees.py --a PARENT_DIR --b . --bert SET [--out FILE]

Each turn is a fresh process run from the checkout's root, so it builds and
loads that checkout's own kernels (into its own ``build/``) and imports its
own ``horovod_tpu_torch`` and ``chip_smoke.py``. A turn times the three
kernels at the main-path shape (B=8, T=1024, H=12, D=64, bf16, causal; the
median of 5 turns of 50 launches, CUDA events) and runs that checkout's
``chip_smoke.train`` (5 GptSmall steps on NCCL). The summary gives each
checkout's medians over its two turns and the card's name and power limit;
``--out`` also writes it as JSON. Both checkouts must have the kernel
wrappers of ``horovod_tpu_torch/ops/flash_attention.py`` with the same
arguments. With ``--bert SET`` a turn instead runs 5 BERT-Large steps of
that option set of ``chip_smoke.BERT_SETS`` (seq 512, batch 8, weights
from seed 0) through the checkout's ``chip_smoke.bert_step`` and one more
under ``chip_smoke.profile_step``, and the summary gives each checkout's
median steady step and device-busy time of the profiled step.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def measure() -> dict:
    """One turn, in the checkout this process runs from."""
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    if not torch.cuda.is_available():
        raise SystemExit("compare_trees: no CUDA device")
    device = torch.device("cuda", 0)
    _build.build()
    m = dict(b=8, tq=1024, tk=1024, h=12, d=64, bq=512, bk=512,
             causal=True, dtype=torch.bfloat16)
    q, k, v, do, dlse = cs.kernel_inputs(m, device)
    args = (True, m["d"] ** -0.5, 0.0, 0.0, 512, 512)
    o, lse = fa.flash_fwd(q, k, v, *args)
    corr = (dlse - (do.float() * o.float()).sum(-1).transpose(1, 2)) \
        .contiguous()
    runs = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, *args),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, corr,
                                                    *args),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, corr,
                                                      *args)}
    kernels = {}
    for name, fn in runs.items():
        turns = [cs.time_ms(fn, 50) for _ in range(5)]
        kernels[name] = {"ms": statistics.median(turns), "ms_turns": turns}
    del q, k, v, do, o, lse, corr
    torch.cuda.empty_cache()
    line = cs.train(device)[-1]  # the train line, last in every version
    return {"kernels": kernels, "steady_step_ms": line["steady_step_ms"],
            "step_ms": line["step_ms"], "tokens_per_s": line["tokens_per_s"],
            "losses": line["losses"]}


def measure_bert(set_name: str) -> dict:
    """One turn of BERT-Large option set ``set_name``, in the checkout
    this process runs from."""
    import time
    import numpy as np
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import BertLarge
    from horovod_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        raise SystemExit("compare_trees: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    _build.build()
    opts = dict(cs.BERT_SETS)[set_name]
    hvd.init()
    try:
        base = BertLarge(dtype=torch.bfloat16, max_len=cs.BERT["seq"])
        base.reset_parameters(torch.Generator().manual_seed(0))
        model = cs.bert_model(base.state_dict(), device)
        del base
        rs = np.random.RandomState(0)
        batch = {k: torch.tensor(rs.randint(
            0, cs.BERT["vocab"], (cs.BERT["batch"], cs.BERT["seq"]))).to(
                device) for k in ("tokens", "labels")}
        step = cs.bert_step(model, opts)
        losses, step_ms = [], []
        for _ in range(cs.STEPS):
            t0 = time.perf_counter()
            losses.append(step(batch).loss.item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        prof = cs.profile_step(step, batch, None)
    finally:
        hvd.shutdown()
    return {"bert_set": set_name, "step_ms": step_ms, "losses": losses,
            "steady_step_ms": sum(step_ms[1:]) / len(step_ms[1:]),
            "device_busy_ms": prof["device_busy_ms"],
            "device_ms_by_class": prof["device_ms_by_class"]}


def turn(tree: str, bert=None) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    cmd = [sys.executable, os.path.abspath(__file__), "--measure"] + \
        (["--bert", bert] if bert else [])
    out = subprocess.run(cmd, cwd=tree, env=env, text=True,
                         capture_output=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"turn in {tree} failed ({out.returncode}):\n"
                           f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="first checkout (e.g. the parent commit)")
    ap.add_argument("--b", help="second checkout (e.g. this one)")
    ap.add_argument("--out", default=None, help="write the summary here")
    ap.add_argument("--measure", action="store_true",
                    help="one turn in the current directory (internal)")
    ap.add_argument("--bert", default=None,
                    help="time this BERT-Large option set of "
                         "chip_smoke.BERT_SETS instead")
    opts = ap.parse_args()
    if opts.measure:
        print(json.dumps(measure_bert(opts.bert) if opts.bert
                         else measure()), flush=True)
        return 0
    if not (opts.a and opts.b):
        ap.error("--a and --b are required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    order = [("a", opts.a), ("b", opts.b), ("b", opts.b), ("a", opts.a)]
    turns = {"a": [], "b": []}
    for label, tree in order:
        res = turn(tree, opts.bert)
        turns[label].append(res)
        print(json.dumps({"turn": label, "tree": tree, **res}), flush=True)
    summary = {"card": card.splitlines()[0], "order": "a b b a"}
    if opts.bert:
        for label, tree in (("a", opts.a), ("b", opts.b)):
            summary[label] = {"tree": tree, "bert_set": opts.bert,
                              "steady_step_ms": statistics.median(
                                  [t["steady_step_ms"] for t in turns[label]]),
                              "steady_step_ms_turns": [
                                  t["steady_step_ms"] for t in turns[label]],
                              "device_busy_ms": statistics.median(
                                  [t["device_busy_ms"] for t in turns[label]]),
                              "device_busy_ms_turns": [
                                  t["device_busy_ms"] for t in turns[label]]}
        summary["b_over_a"] = summary["b"]["steady_step_ms"] / \
            summary["a"]["steady_step_ms"]
        if opts.out:
            with open(opts.out, "w") as f:
                json.dump({"summary": summary, "turns": turns}, f, indent=1)
        print(json.dumps(summary), flush=True)
        return 0
    for label, tree in (("a", opts.a), ("b", opts.b)):
        ts = turns[label]
        summary[label] = {
            "tree": tree,
            "kernels_ms": {n: statistics.median(
                [x for t in ts for x in t["kernels"][n]["ms_turns"]])
                for n in KERNELS},
            "steady_step_ms": statistics.median(
                [t["steady_step_ms"] for t in ts]),
            "tokens_per_s": statistics.median(
                [t["tokens_per_s"] for t in ts])}
    summary["speedup"] = {n: summary["a"]["kernels_ms"][n] /
                          summary["b"]["kernels_ms"][n] for n in KERNELS}
    summary["speedup"]["step"] = summary["a"]["steady_step_ms"] / \
        summary["b"]["steady_step_ms"]
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump({"summary": summary, "turns": turns}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
