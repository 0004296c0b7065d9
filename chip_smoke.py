#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU (H100).

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit:

    python3 chip_smoke.py [--out DIR] [--profile]

Phases, one JSON line each on stdout; any failure raises and exits non-zero:

1. device    - card name and power limit (nvidia-smi);
2. build     - nvcc builds the three flash-attention kernels from
               horovod_tpu_torch/ops/csrc, both sources at once;
3. resources - registers, spills, shared memory and blocks per SM of every
               kernel as the card reports them; the bf16 TMA/wgmma kernels
               must not spill;
4. kernels   - each CUDA kernel against its plain PyTorch version on the
               same card tensors: the GPT-2-small shape (bf16, causal and
               not), the BERT-Large shape (bf16, non-causal), and small
               fp32/bf16 shapes with offsets, a fully-future
               block, Tq != Tk, ragged lengths, a single tile, one q tile
               against 1024 keys, rows with no visible key under 512-row
               reference tiles, and return_lse with a dlse cotangent, o
               compared on every row; the parallel path's shapes: the
               world-1 ring's one call (B=1, T=32768, H=12, causal) and
               one of four ranks' ring shards (T=8192, dlse) at the
               global offsets of rank 3's blocks (k at 0, 16384 and 24576
               with q at 24576) and of a block wholly in the future; then
               flash_attention's autograd on the card (offsets, dlse)
               against float64 attention;
5. parity    - a small fp32 GptDecoder at T=1024 on the card, flash
               kernels against dense attention with the same weights:
               logits and gradients;
6. timing    - each kernel, its plain version and torch's
               scaled_dot_product_attention forward and backward (yardstick
               only; the port never calls it) beside the bound, each the
               median of 5 turns: at the GPT-2-small shape (causal), at
               the BERT-Large shape (non-causal, all T^2 pairs) and at two
               blocks of one of four ranks' ring shard (B=1, T=8192, H=12,
               causal, q at global position 24576): its diagonal block (k
               at 24576) and an off-diagonal one (k at 0, every pair
               visible, against SDPA without a mask);
7. crossover - dense against flash attention, forward plus backward, over
               the key length (the routing threshold DEFAULT_FLASH_MIN_SEQ);
8. train     - the main path: init() on NCCL, GptSmall (bf16 compute, fp32
               params) at seq 1024 and batch 8, make_train_step with AdamW
               and bf16 gradient compression, 5 steps on one fixed batch;
               the loss must be finite and fall, and each kernel must have
               launched 12 times per step;
9. collectives - every collective of parallel/collectives.py once on card
               tensors, on NCCL at world 1, in fp32, bf16 and int32, each
               equal to its world-1 value (Adasum and a reversed axis tuple
               included), the int8 quantized allreduce within its bound;
               then SyncBatchNorm forward and backward against the
               ResNet's plain BatchNorm on the same tensors;
10. frontend - the user frontend at world 1 on NCCL: every eager op
               (name-negotiated, fp32, bf16 and int32, each equal to its
               world-1 value; barrier, poll before and after completion,
               join, metric_average, broadcast_object, allgather_object),
               the median latency of a 4-byte and a 64 MiB
               synchronize(allreduce_async()) beside the in-step
               allreduce; GptSmall at seq 1024 and batch 8 trained as a
               user writes the loop (broadcast_parameters,
               DistributedOptimizer(AdamW, bf16 wire, two backward passes
               per step), broadcast_optimizer_state, 10 microsteps): the
               loss must fall, each kernel launch 12 times per microstep,
               the parameters stay put off the boundary; one
               DistributedOptimizer step equal to one make_train_step step
               within rtol 1e-6; MNIST (BASELINE config 1) through
               DistributedOptimizer(SGD(momentum=0.9)), 20 steps, the loss
               must fall;
11. bert     - the third main path: init() on NCCL, BertLarge (bf16
               compute, fp32 params, flash attention, non-causal) at seq
               512 and batch 8, random tokens and labels from seed 0,
               make_train_step with AdamW(1e-4), 5 steps under each option
               set: fp16 wire; fp16 wire with 64 MiB buckets; ZeRO-1 with
               the int8 wire and 64 MiB buckets. Before them, on one set of
               gradients: bucketed equals fused bit for bit (fp32 and fp16
               wire), int8 the same bits at 64 and 8 MiB buckets, Adasum of
               one replica its input, and one ZeRO-1 step within rtol 1e-5
               of one replicated step. In each set the loss must be finite
               and fall and each kernel launch 24 times per step; with
               buckets, some must be launched before the backward ends;
12. resnet   - the second main path: init() on NCCL, ResNet50 (bf16
               compute, fp32 params and BatchNorm statistics) on 224x224x3
               NHWC images, 1000 classes, batch 128,
               make_stateful_train_step with SGD(lr=0.05, momentum=0.9), 5
               steps on one fixed batch from seed 0 (the configuration of
               examples/jax/jax_synthetic_benchmark.py); the loss must be
               finite and fall and every running statistic must have moved
               and stay finite and fp32. It runs no flash kernel;
13. parallel - the sequence, tensor, pipeline and expert axes at world 1
               on NCCL, at GPT-2 small's widths, each forward+backward
               against the single-card computation (errors, median ms of
               5, peak memory, flash launches): ring attention on the flash
               kernels at B=1, T=32768, H=12, D=64, bf16, causal (bit-equal
               to one flash_attention call, outputs and q/k/v gradients),
               the plain ring at T=8192 against dense_attention, Ulysses
               on the flash kernels at T=32768 (bit-equal); tp_mlp and
               tp_mlp_inference (fp32 and int8 wires) at x [8, 1024, 768]
               against the dense MLP; pipeline_apply of GPT-2 small's 12
               causal blocks at batch 8 x seq 1024, n_micro 8, against the
               blocks in order (outputs and the stage's gradients);
               moe_layer on 8192 tokens, 8 experts of hidden 3072,
               capacity factor 1.25 (no token dropped) and 0.5 (some must
               be), against the dense per-token MoE.

The train, frontend, bert and resnet lines carry the port's MFU
(profiler/mfu.py ``mfu_report``: FLOPs per token or image from
FlopCounterMode plus the flash kernels' share, over the card's bf16 peak),
which must lie in (0, 1]. Then the kernels line (launches per path: gpt,
frontend, bert, resnet, parallel), the nvidia-smi line, and the final
``{"ok": true, "device": ...}`` line. ``--out DIR`` also writes the nvcc
logs there; ``--profile`` adds one profiled GPT train step, one profiled
BERT-Large step per option set and one profiled ResNet-50 step (device
time by kernel, device idle share) and, with ``--out``, their Chrome
traces.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

MAIN = dict(b=8, t=1024, h=12, d=64)  # GPT-2 small, per-GPU batch 8
BERT_SHAPE = dict(b=8, t=512, h=16, d=64)  # BERT-Large, per-GPU batch 8
STEPS = 5
REPLACES = {
    "flash_fwd": ("horovod_tpu_torch/ops/csrc/flash_fwd.cu",
                  "horovod_tpu/ops/flash_attention.py:70"),
    "flash_bwd_dq": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                     "horovod_tpu/ops/flash_attention.py:118"),
    "flash_bwd_dkv": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                      "horovod_tpu/ops/flash_attention.py:155"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels against their plain versions


def torch_norm(x) -> float:
    return float(x.double().norm()) if x.numel() else 0.0


def close(name, got, want, rtol, atol, row_atol=0.0, norm_tol=None):
    """Elementwise |got - want| <= atol + row_atol * max|want over its row|
    + rtol * |want|, a row being the last dim (one query's output, one
    key's gradient), and with ``norm_tol`` also the normwise
    ||got - want|| / ||want|| <= norm_tol. Returns (max absolute error,
    normwise error); raises on disagreement."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    row_max = want.abs().amax(-1, keepdim=True) if want.numel() else want
    bad = err > atol + row_atol * row_max + rtol * want.abs()
    norm_err = float(torch_norm(got - want) / max(torch_norm(want), 1e-30))
    if bool(bad.any()) or not math.isfinite(max_err):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements off (max abs err {max_err}, "
            f"rtol {rtol}, atol {atol}, row atol {row_atol})")
    if norm_tol is not None and not norm_err <= norm_tol:
        raise AssertionError(f"{name}: normwise error {norm_err} exceeds "
                             f"{norm_tol}")
    return max_err, norm_err


def tolerances(dtype):
    """kind -> (rtol, atol, row_atol, norm_tol). fp32: the reference
    tests' tolerances. bf16: the kernel tiles by 64 and the plain version
    by 512, so p is rounded to bf16 against another running max and sums
    run in another order; each element may be off by a few bf16 ulps
    (2^-8 relative) of its own value or of the largest value in its row,
    and the whole tensor by about one ulp in norm. Scaling by the row
    keeps late causal rows, which average hundreds of keys and are far
    smaller than the first rows, to their own resolution."""
    import torch
    if dtype == torch.float32:
        return dict(fwd=(2e-4, 2e-5, 0.0, None), grad=(2e-3, 2e-4, 0.0, None),
                    lse=(1e-4, 1e-5, 0.0, None))
    return dict(fwd=(2e-2, 1e-6, 2e-2, 1e-2), grad=(2e-2, 1e-6, 2e-2, 1e-2),
                lse=(1e-4, 2e-3, 0.0, None))


NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the kernel cases at the shapes the main paths give the kernels (GPT-2
# small causal, BERT-Large non-causal, the world-1 ring's one call): the
# kernels line's max_abs_err
MAIN_PATH_CASES = ("main_bf16_causal", "bertlarge_bf16_full",
                   "par_bf16_t32768_causal")


def kernel_resources():
    """Registers, spill bytes, shared memory and resident blocks per SM of
    every kernel instantiation, as the card reports them. The bf16
    TMA/wgmma kernels (forward, dq and dk/dv) must not spill: their
    accumulators are meant to live in registers."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    out = {}
    for name in NAMES:
        for dt in (torch.float32, torch.bfloat16):
            for d in (32, 64, 128):
                info = fa.kernel_info(name, dt, d)
                key = f"{name}/{str(dt)[6:]}/d{d}"
                out[key] = info
                if dt == torch.bfloat16 and info["local_bytes"]:
                    raise AssertionError(f"{key} spills: {info}")
    return out


def kernel_inputs(case, device):
    import torch
    g = torch.Generator().manual_seed(case.get("seed", 0))
    dt = case["dtype"]
    b, tq, tk, h, d = case["b"], case["tq"], case["tk"], case["h"], case["d"]
    q = torch.randn(b, tq, h, d, generator=g).to(device, dt)
    k = torch.randn(b, tk, h, d, generator=g).to(device, dt)
    v = torch.randn(b, tk, h, d, generator=g).to(device, dt)
    do = torch.randn(b, tq, h, d, generator=g).to(device, dt)
    dlse = torch.randn(b, h, tq, generator=g).to(device) \
        if case.get("dlse") else torch.zeros(b, h, tq, device=device)
    return q, k, v, do, dlse


def check_case(case, device):
    """Each kernel and its plain version on identical card tensors: the
    backward kernels get the plain forward's lse and corr."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, dlse = kernel_inputs(case, device)
    args = (case["causal"], case["d"] ** -0.5, case.get("q_off", 0.0),
            case.get("k_off", 0.0), case["bq"], case["bk"])
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, *args)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2)
    corr = (dlse - delta).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, corr, *args)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, corr, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, corr, *args)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, corr, *args)
    torch.cuda.synchronize()
    name = case["name"]
    live = lse_p > fa.NEG_INF / 2
    # every row, rows with no visible key included: their o is the mean of
    # v over the keys of the reference's tiles, which the kernel follows
    pairs = {  # output -> (kernel, got, want, tolerance kind)
        "o": ("flash_fwd", o, o_p, "fwd"),
        "lse": ("flash_fwd", lse, lse_p, "lse"),
        "dq": ("flash_bwd_dq", dq, dq_p, "grad"),
        "dk": ("flash_bwd_dkv", dk, dk_p, "grad"),
        "dv": ("flash_bwd_dkv", dv, dv_p, "grad"),
    }
    errs, norms, tols = {}, {}, {}
    for out, (kern, got, want, kind) in pairs.items():
        tol = tolerances(case["dtype"])[kind]
        tols[out] = list(tol)
        err, norms[out] = close(f"{name}/{out}", got, want, *tol)
        errs[kern] = max(errs.get(kern, 0.0), err)
    if not bool(torch.equal(live, lse > fa.NEG_INF / 2)):
        raise AssertionError(f"{name}: dead rows differ")
    if case.get("future"):
        # a block entirely in the future: lse NEG_INF, o and grads zero
        if not (bool((lse < -1e29).all()) and bool((o == 0).all())
                and bool((dq == 0).all()) and bool((dk == 0).all())):
            raise AssertionError(f"{name}: fully-future block not empty")
    return errs, norms, tols


def kernel_cases():
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    m = dict(b=MAIN["b"], tq=MAIN["t"], tk=MAIN["t"], h=MAIN["h"],
             d=MAIN["d"], bq=512, bk=512, dtype=bf16)
    small = dict(b=2, tq=256, tk=256, h=4, bq=128, bk=128)
    bert = dict(b=BERT_SHAPE["b"], tq=BERT_SHAPE["t"], tk=BERT_SHAPE["t"],
                h=BERT_SHAPE["h"], d=BERT_SHAPE["d"], bq=512, bk=512,
                dtype=bf16)
    par = dict(b=PAR["b"], tq=PAR["t"], tk=PAR["t"], h=PAR["h"], d=PAR["d"],
               bq=512, bk=512, causal=True, dtype=bf16)
    shard = dict(par, tq=RING_SHARD["t"], tk=RING_SHARD["t"], dlse=True)
    t = float(RING_SHARD["t"])
    return [
        dict(name="main_bf16_causal", causal=True, **m),
        dict(name="main_bf16_full", causal=False, **m),
        dict(name="bertlarge_bf16_full", causal=False, seed=17, **bert),
        dict(name="f32_d64_causal", d=64, causal=True, dtype=f32, **small),
        dict(name="f32_d64_full", d=64, causal=False, dtype=f32, **small),
        dict(name="f32_d128_lse_dlse", b=2, tq=128, tk=128, h=2, d=128,
             bq=128, bk=128, causal=False, dtype=f32, dlse=True, seed=3),
        dict(name="f32_d32_offsets_tq_ne_tk", b=2, tq=64, tk=128, h=2, d=32,
             bq=64, bk=128, causal=True, q_off=64.0, k_off=0.0, dtype=f32,
             dlse=True, seed=4),
        dict(name="f32_d32_fully_future", b=2, tq=64, tk=128, h=2, d=32,
             bq=64, bk=128, causal=True, q_off=-1000.0, dtype=f32,
             future=True, seed=5),
        dict(name="f32_d64_masked_rows", b=1, tq=128, tk=128, h=2, d=64,
             bq=64, bk=64, causal=True, q_off=-10.0, dtype=f32, seed=6),
        dict(name="f32_d64_ragged_200", b=2, tq=200, tk=200, h=2, d=64,
             bq=200, bk=200, causal=True, dtype=f32, seed=7),
        dict(name="bf16_d128_causal", b=2, tq=256, tk=256, h=2, d=128,
             bq=128, bk=128, causal=True, dtype=bf16, seed=8),
        dict(name="bf16_d32_offsets", b=2, tq=128, tk=256, h=2, d=32,
             bq=128, bk=128, causal=True, q_off=128.0, dtype=bf16,
             dlse=True, seed=9),
        # edges of the TMA/wgmma bf16 kernels: one tile (the ring never
        # fills), a ragged length (TMA zero fill), Tq != Tk with offsets
        # at d=128 (two 64-column panels)
        dict(name="bf16_d64_single_tile_64", b=2, tq=64, tk=64, h=2, d=64,
             bq=64, bk=64, causal=True, dtype=bf16, seed=10),
        dict(name="bf16_d64_ragged_200", b=2, tq=200, tk=200, h=3, d=64,
             bq=200, bk=200, causal=True, dtype=bf16, seed=11),
        dict(name="bf16_d128_offsets_tq_ne_tk", b=2, tq=128, tk=256, h=2,
             d=128, bq=128, bk=128, causal=True, q_off=128.0, k_off=0.0,
             dtype=bf16, dlse=True, seed=12),
        # a ragged key side without a causal mask: keys past Tk arrive as
        # TMA zeros and must weigh nothing
        dict(name="bf16_d32_ragged_65_100_full", b=2, tq=65, tk=100, h=2,
             d=32, bq=65, bk=100, causal=False, dtype=bf16, dlse=True,
             seed=16),
        # one q tile against a long key side: the dq kernel's K/V ring
        # wraps 16 times within one block
        dict(name="bf16_d64_one_q_tile_long_k", b=2, tq=64, tk=1024, h=2,
             d=64, bq=64, bk=1024, causal=False, dtype=bf16, dlse=True,
             seed=15),
        # rows with no visible key under the reference's 512-row tiling:
        # o is the mean of v over the first 512 keys (ROADMAP C1)
        dict(name="f32_d64_dead_rows_512", b=1, tq=1024, tk=1024, h=2,
             d=64, bq=512, bk=512, causal=True, q_off=-10.0, dtype=f32,
             seed=13),
        dict(name="bf16_d64_dead_rows_512", b=1, tq=1024, tk=1024, h=2,
             d=64, bq=512, bk=512, causal=True, q_off=-10.0, dtype=bf16,
             seed=14),
        # the parallel path: the world-1 ring's one call over the whole
        # sequence, and the shards four ranks' rings give the kernels, with
        # the merge's lse cotangent: rank 3's queries against keys wholly
        # visible (from rank 0), from rank 2 and its own diagonal, and rank
        # 2's queries against rank 3's keys, wholly in the future
        dict(name="par_bf16_t32768_causal", seed=18, **par),
        dict(name="ring_shard_q24576_k0", q_off=3 * t, k_off=0.0, seed=19,
             **shard),
        dict(name="ring_shard_q24576_k16384", q_off=3 * t, k_off=2 * t,
             seed=20, **shard),
        dict(name="ring_shard_q24576_k24576", q_off=3 * t, k_off=3 * t,
             seed=21, **shard),
        dict(name="ring_shard_q16384_k24576_future", q_off=2 * t,
             k_off=3 * t, future=True, seed=22, **shard),
    ]


def autograd_check(device):
    """flash_attention end to end on the card (return_lse, a dlse
    cotangent, global offsets, Tq != Tk) against float64 dense attention
    with the same mask, differentiated by autograd on the CPU. The float64
    reference keeps the check independent of the host's fp32 BLAS."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    g = torch.Generator().manual_seed(11)
    tq, tk, q_off = 128, 256, 128.0
    q = torch.randn(2, tq, 2, 64, generator=g)
    k, v = (torch.randn(2, tk, 2, 64, generator=g) for _ in range(2))
    do = torch.randn(2, tq, 2, 64, generator=g)
    dl = torch.randn(2, 2, tq, generator=g)

    ts = [x.to(device).detach().requires_grad_(True) for x in (q, k, v)]
    o, lse = fa.flash_attention(*ts, causal=True, q_offset=q_off,
                                k_offset=0.0, return_lse=True, block_q=64,
                                block_k=64)
    ((o * do.to(device)).sum() + (lse * dl.to(device)).sum()).backward()
    got = [o.detach().cpu(), lse.detach().cpu()] + [t.grad.cpu() for t in ts]

    rs = [x.detach().double().requires_grad_(True) for x in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", rs[0], rs[1]) / 8.0
    visible = (q_off + torch.arange(tq))[:, None] >= torch.arange(tk)[None]
    s = torch.where(visible, s, float("-inf"))
    lse_r = torch.logsumexp(s, -1)
    o_r = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), rs[2])
    ((o_r * do.double()).sum() + (lse_r * dl.double()).sum()).backward()
    want = [o_r.detach(), lse_r.detach()] + [r.grad for r in rs]

    errs = {}
    for i, name in enumerate(("o", "lse", "dq", "dk", "dv")):
        rtol, atol = (2e-4, 2e-5) if i < 2 else (2e-3, 2e-4)
        errs[name] = close(f"autograd/{name}", got[i], want[i].float(), rtol,
                           atol)[0]
    return errs


# ---------------------------------------------------------------------------
# timing


_SLEEP_CYCLES_PER_MS = []


def busy_wait_card(ms: float) -> None:
    """Enqueue a kernel that keeps the card busy for about ``ms``."""
    import torch
    if not _SLEEP_CYCLES_PER_MS:
        # the first launch loads the kernel: keep that out of the reading
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10 ** 7 / start.elapsed_time(end))
    torch.cuda._sleep(int(ms * _SLEEP_CYCLES_PER_MS[0]))


def time_ms(fn, iters, warmup=3):
    """Card time of one ``fn`` call: events around ``iters`` calls, after a
    busy-wait kernel that lasts twice as long as the host takes to enqueue
    them (read from the warm-up), so that the events time the card's work
    and not the host's launch rate."""
    import torch
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    busy_wait_card(min(2 * host_ms * iters + 1.0, 1000.0))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bounds(b, t, h, d, causal, dtype_name, q_off=0.0, k_off=0.0):
    """Least time (ms) per kernel: each input read once and each output
    written once at the memory rate, against the products this run's data
    needs (only the causally visible q-k pairs, at these offsets) at the
    tensor-core rate. The exp and elementwise work is not counted."""
    from horovod_tpu_torch.profiler.flops import attention_pairs
    esize = 2 if dtype_name == "bfloat16" else 4
    pairs = b * h * attention_pairs(t, t, causal, q_off, k_off)
    x = b * t * h * d * esize          # one [B, T, H, D] tensor
    row = b * h * t * 4                # one [B, H, T] fp32 tensor
    work = {  # name -> (bytes, flops)
        "flash_fwd": (3 * x + x + row, 2 * 2 * pairs * d),
        "flash_bwd_dq": (4 * x + 2 * row + x, 3 * 2 * pairs * d),
        "flash_bwd_dkv": (4 * x + 2 * row + 2 * x, 4 * 2 * pairs * d),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, flops)
    return out


TURNS = 5  # every reported time is the median of this many turns


def timing(device, shape=MAIN, causal=True, q_off=0.0, k_off=0.0):
    """Each kernel, its plain version and the SDPA yardstick at ``shape``
    (bf16), with q and k at global positions ``q_off`` and ``k_off``: a
    ring shard's diagonal block (equal offsets, the same function as
    offset 0, which SDPA computes causally) or a block whose every pair is
    visible (SDPA without a mask). Kernel and plain version alternate turn
    by turn; each time is the median of TURNS turns (a kernel turn is 50
    launches)."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.profiler.flops import attention_pairs
    t = shape["t"]
    every_pair = attention_pairs(t, t, causal, q_off, k_off) == t * t
    if causal and q_off != k_off and not every_pair:
        raise ValueError("SDPA has no mask for a block at these offsets")
    sdpa_causal = causal and not every_pair
    case = dict(name="timing", causal=causal, b=shape["b"], tq=shape["t"],
                tk=shape["t"], h=shape["h"], d=shape["d"], bq=512, bk=512,
                dtype=torch.bfloat16)
    q, k, v, do, dlse = kernel_inputs(case, device)
    args = (causal, shape["d"] ** -0.5, q_off, k_off, 512, 512)
    o, lse = fa.flash_fwd(q, k, v, *args)
    corr = (dlse - (do.float() * o.float()).sum(-1).transpose(1, 2)) \
        .contiguous()
    runs = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, *args),
                      lambda: fa.flash_fwd_plain(q, k, v, *args)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, corr, *args),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, corr, *args)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, corr, *args),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, corr, *args)),
    }
    res = {}
    for name, (kern, plain) in runs.items():
        kt, pt = [], []
        for _ in range(TURNS):
            pt.append(time_ms(plain, 3, warmup=1))
            kt.append(time_ms(kern, 50))
        res[name] = {"ms": statistics.median(kt),
                     "plain_ms": statistics.median(pt),
                     "ms_turns": kt, "plain_ms_turns": pt}
    # yardstick: one library call on the same inputs in SDPA's [B, H, T, D];
    # its backward alone is autograd.grad on a retained graph
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qh, kh, vh))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=sdpa_causal)
    fwd_t, bwd_t = [], []
    for _ in range(TURNS):
        fwd_t.append(time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=sdpa_causal), 50))
        bwd_t.append(time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), doh, retain_graph=True), 50))
    sdpa_fwd, sdpa_bwd = statistics.median(fwd_t), statistics.median(bwd_t)
    # no single library call computes dq or dk/dv alone: SDPA's whole
    # backward is the joint yardstick of the two backward kernels together
    res["flash_fwd"].update(library_ms=sdpa_fwd, library_ms_joint=None)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        res[name].update(library_ms=None, library_ms_joint=sdpa_bwd)
    bnd = bounds(shape["b"], shape["t"], shape["h"], shape["d"], causal,
                 "bfloat16", q_off, k_off)
    for name, (ms, by, nbytes, flops) in bnd.items():
        res[name].update(bound_ms=ms, bound_by=by, bytes=nbytes,
                         flops=flops, share_of_bound=ms / res[name]["ms"])
    return res, {"sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd,
                 "sdpa_fwd_ms_turns": fwd_t, "sdpa_bwd_ms_turns": bwd_t,
                 "busy_wait_cycles_per_ms": _SLEEP_CYCLES_PER_MS[0]}


CROSSOVER_T = (256, 512, 1024, 2048)


def crossover(device):
    """Dense attention against the flash kernels, forward plus backward
    through the public functions, at the main shape's B, H, D (bf16,
    causal) over the key length: the routing crossover of
    ``attention`` (DEFAULT_FLASH_MIN_SEQ). Returns the times and the
    shortest swept length from which flash is no slower at every longer
    swept length (None if dense wins at the longest)."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    rows = []
    for t in CROSSOVER_T:
        case = dict(b=MAIN["b"], tq=t, tk=t, h=MAIN["h"], d=MAIN["d"],
                    dtype=torch.bfloat16, seed=t)
        q, k, v, do, _ = kernel_inputs(case, device)
        ts = [x.requires_grad_(True) for x in (q, k, v)]

        def fwd_bwd(fn):
            out = fn(*ts, causal=True)
            torch.autograd.grad(out, ts, do)
        dense_t, flash_t = [], []
        for _ in range(TURNS):
            dense_t.append(time_ms(lambda: fwd_bwd(fa.dense_attention), 10))
            flash_t.append(time_ms(lambda: fwd_bwd(fa.flash_attention), 10))
        rows.append({"tk": t, "dense_ms": statistics.median(dense_t),
                     "flash_ms": statistics.median(flash_t),
                     "dense_ms_turns": dense_t, "flash_ms_turns": flash_t})
        del q, k, v, do, ts
        torch.cuda.empty_cache()
    cross = None
    for row in reversed(rows):
        if row["flash_ms"] > row["dense_ms"]:
            break
        cross = row["tk"]
    return {"phase": "crossover", "b": MAIN["b"], "h": MAIN["h"],
            "d": MAIN["d"], "dtype": "bfloat16", "causal": True,
            "rows": rows, "flash_no_slower_from_tk": cross,
            "default_flash_min_seq": fa.DEFAULT_FLASH_MIN_SEQ}


# ---------------------------------------------------------------------------
# model phases


def parity(device):
    """A small fp32 GptDecoder at T=1024 on the card: every layer on the
    flash kernels against the same weights with dense attention
    (``use_flash=False``: fp32 cuBLAS, TF32 off), logits and gradients."""
    import torch
    from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
    cfg = dict(vocab=256, layers=2, hidden=128, heads=2, mlp_dim=512,
               max_len=1024, dtype=torch.float32)
    base = GptDecoder(**cfg)
    base.reset_parameters(torch.Generator().manual_seed(1))
    tokens = torch.randint(0, 256, (2, 1024),
                           generator=torch.Generator().manual_seed(2))
    tokens = tokens.to(device)
    results = []
    for use_flash in (True, False):
        model = GptDecoder(use_flash=use_flash, **cfg)
        model.load_state_dict(base.state_dict())
        model.to(device)
        logits = model(tokens)
        loss, _ = lm_loss(model, tokens)
        loss.backward()
        results.append((logits.detach().cpu(),
                        {n: p.grad.cpu() for n, p in
                         model.named_parameters()}))
    (lg, gg), (ld, gd) = results
    if lg.shape != (2, 1024, 256) or not bool(torch.isfinite(lg).all()):
        raise AssertionError("parity: bad logits")
    err = {"logits": close("parity/logits", lg, ld, 2e-4, 2e-5)[0]}
    err["grads"] = max(close(f"parity/grad/{n}", gg[n], gd[n], 2e-3, 2e-4)[0]
                       for n in gd)
    return err


# kernel-name patterns of each class, checked in this order; the rest is
# elementwise
KERNEL_CLASSES = (
    ("flash", ("hvdflash",)),
    ("pool", ("pool",)),
    ("nccl", ("nccl",)),
    ("conv_gemm", ("conv", "xmma", "gemm", "cutlass", "nvjet", "cudnn")),
    ("reduction", ("reduce_kernel", "softmax")),
    ("copy", ("copy", "memcpy", "memset")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    return next((cls for cls, keys in KERNEL_CLASSES
                 if any(k in low for k in keys)), "elementwise")


def profile_step(step, batch, out_dir, trace_name="train_step.json"):
    """One more train step under torch.profiler: device time by kernel
    (top 15) and by class of kernel (KERNEL_CLASSES), and the device's
    busy share of the step's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch).loss.item()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, trace_name))

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))
    # device-side kernels only: an operator's entry, and a user annotation
    # such as the optimizer step's, repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    events.sort(key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    by_class: dict = {}
    for e in events:
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us(e) / 1e3
    return {"phase": "profile", "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "device_ms_by_class": by_class,
            "top": [{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                     "count": e.count} for e in events[:15]]}


def train(device, profile_dir=None, profile=False):
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.gpt import GptSmall, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import dp
    hvd.init()  # cuda:local_rank on NCCL, world size from the env (1)
    try:
        model = GptSmall(dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(0))
        n_params = sum(p.numel() for p in model.parameters())
        tokens = torch.randint(0, 50257, (MAIN["b"] * hvd.size(), MAIN["t"]),
                               generator=torch.Generator().manual_seed(0))
        batch = dp.shard_batch(tokens).to(hvd.device())
        est = step_flops(lm_loss, model.to(hvd.device()), batch)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        step = dp.make_train_step(model, lm_loss, opt,
                                  compression=hvd.Compression.bf16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        losses, step_ms = [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            out = step(batch)
            losses.append(out.loss.item())  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = fa.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        prof = profile_step(step, batch, profile_dir) if profile else None
    finally:
        hvd.shutdown()
    layers = len(model.blocks)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall {losses}")
    want = layers * STEPS
    if counts != {k: want for k in counts}:
        raise AssertionError(f"train: launches {counts}, want {want} each")
    steady = step_ms[1:]
    mean_ms = sum(steady) / len(steady)
    tokens = MAIN["b"] * MAIN["t"]
    return counts, prof, est, {
        "phase": "train", "model": "GptSmall", "params": n_params,
        "batch": MAIN["b"], "seq": MAIN["t"], "steps": STEPS,
        "losses": losses, "step_ms": step_ms,
        "steady_step_ms": mean_ms,
        "tokens_per_s": tokens / (mean_ms / 1e3),
        "mfu": mfu_entry(est, tokens, tokens / (mean_ms / 1e3)),
        "peak_mem_bytes": peak, "launches": counts,
        "backend": "nccl", "world_size": 1}


# ---------------------------------------------------------------------------
# the collectives and SyncBatchNorm, the ResNet-50 path


def collectives_check(device):
    """Every collective at world 1 on NCCL, each equal to its world-1
    value (exactly: one replica's sum, product, gather, exchange or Adasum
    is its own input), in fp32, bf16 and int32, and the int8 quantized
    allreduce within its bound; then SyncBatchNorm against the
    ResNet's BatchNorm (both with flax's momentum) on the same card
    tensors, forward and backward."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import collectives as c
    hvd.init()
    checked, quant_err = [], {}
    try:
        g = torch.Generator().manual_seed(5)
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            x = (torch.randn(8, 4, generator=g) * 4).to(device, dt)
            one = [(f"allreduce_{op.name.lower()}",
                    c.allreduce(x, op=op), x)
                   for op in (c.Sum, c.Average, c.Min, c.Max, c.Product)]
            pairs = one + [
                ("grouped_allreduce", c.grouped_allreduce([x, x[0]])[1],
                 x[0]),
                ("hierarchical_allreduce", c.hierarchical_allreduce(x),
                 c.allreduce(x)),
                ("hierarchical_max", c.hierarchical_allreduce(x, op=c.Max),
                 x),
                ("allgather", c.allgather(x), x),
                ("alltoall", c.alltoall(x), x),
                ("alltoall_1_0", c.alltoall(x, split_axis=1, concat_axis=0),
                 x),
                ("reducescatter_average", c.reducescatter(x), x),
                ("reducescatter_sum", c.reducescatter(x, op=c.Sum), x),
                ("ppermute_identity", c.ppermute(x, [(0, 0)]), x),
                ("ppermute_empty", c.ppermute(x, []), torch.zeros_like(x)),
                ("broadcast", c.broadcast(x, 0, axis=("data", "fsdp")), x),
                # the other mesh axes, each of size 1 here
                ("allreduce_model", c.allreduce(x, op=c.Sum, axis="model"),
                 x),
                ("alltoall_seq", c.alltoall(x, axis="seq"), x),
                ("ppermute_pipe", c.ppermute(x, [(0, 0)], axis="pipe"), x),
                ("allgather_expert_seq",
                 c.allgather(x, axis=("expert", "seq")), x),
            ]
            pairs += [("allgather_fsdp", c.allgather(x, axis="fsdp"), x),
                      ("allgather_data_fsdp",
                       c.allgather(x, axis=("data", "fsdp")), x),
                      ("allgather_fsdp_data",
                       c.allgather(x, axis=("fsdp", "data")), x),
                      # Adasum of one replica is its input (adasum.py)
                      ("allreduce_adasum", c.allreduce(x, op=c.Adasum), x),
                      ("grouped_allreduce_adasum",
                       c.grouped_allreduce([x, x[0]], op=c.Adasum)[1], x[0]),
                      ("allreduce_async",
                       c.allreduce(x, op=c.Sum, async_op=True).wait(), x)]
            for name, got, want in pairs:
                if got.dtype != want.dtype or got.device != x.device or \
                        not bool(torch.equal(got, want)):
                    raise AssertionError(f"collectives: {name} {dt} differs "
                                         "from its world-1 value")
                checked.append(f"{name}/{str(dt)[6:]}")
            if dt.is_floating_point:
                # two int8 round trips: within the reference's bound of
                # 2 max|x| / 127 (test_zero_sharding.py:165-185)
                got = c.quantized_allreduce(x, axis=("data", "fsdp"))
                quant_err[str(dt)[6:]] = close(
                    f"collectives: quantized_allreduce {dt}", got, x, 0.0,
                    2 * float(x.float().abs().max()) / 127)[0]
            c.barrier()
        bn_err = sync_bn_check(device)
    finally:
        hvd.shutdown()
    return {"phase": "collectives", "backend": "nccl", "world_size": 1,
            "checked": len(checked), "cases": checked,
            "quantized_allreduce_max_abs_err": quant_err,
            "sync_batch_norm_max_rel_err": bn_err}


def sync_bn_check(device):
    """SyncBatchNorm (NHWC, features last) and the ResNet's BatchNorm
    (the same tensor seen as NCHW) on one [32, 28, 28, 128] fp32 card
    tensor: outputs, input, scale and bias gradients and running
    statistics within 1e-5 of the largest value of each, elementwise, and
    1e-5 normwise."""
    import torch
    from horovod_tpu_torch.models.resnet import BatchNorm
    from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm
    g = torch.Generator().manual_seed(6)
    x = (torch.randn(32, 28, 28, 128, generator=g) * 2 + 0.5).to(device)
    cot = torch.randn(32, 28, 28, 128, generator=g).to(device)
    scale = torch.rand(128, generator=g).to(device) + 0.5
    bias = torch.randn(128, generator=g).to(device)
    outs = []
    for sync in (True, False):
        bn = (SyncBatchNorm(128) if sync else BatchNorm(128)).to(device)
        with torch.no_grad():
            bn.scale.copy_(scale)
            bn.bias.copy_(bias)
        xg = x.clone().requires_grad_(True)
        y = bn(xg) if sync else bn(xg.permute(0, 3, 1, 2), True) \
            .permute(0, 2, 3, 1)
        (y * cot).sum().backward()
        outs.append({"y": y.detach(), "dx": xg.grad, "dscale": bn.scale.grad,
                     "dbias": bn.bias.grad, "mean": bn.mean.clone(),
                     "var": bn.var.clone()})
    torch.cuda.synchronize()
    errs = {}
    for key, want in outs[1].items():
        got = outs[0][key]
        scale_of = float(want.abs().max())
        errs[key] = close(f"sync_batch_norm/{key}", got, want, 0.0,
                          1e-5 * scale_of, norm_tol=1e-5)[0] / scale_of
    return errs


# ---------------------------------------------------------------------------
# the user frontend (BASELINE config 1: "PyTorch-style MNIST
# (DistributedOptimizer)"): the eager ops, the broadcast helpers, and
# GPT-2 small and MNIST trained through DistributedOptimizer

FRONT = dict(micro=10, bpps=2, lr=3e-4, weight_decay=1e-4,
             mnist_batch=64, mnist_steps=20, mnist_lr=0.01,
             small_iters=50, big_bytes=64 << 20, big_iters=10, step_iters=4)


def eager_ops_check(device):
    """Every eager op on card tensors at world 1 through the name
    negotiation and NCCL, each equal to its world-1 value (one rank's
    reduction, gather, exchange or broadcast is its input), in fp32, bf16
    and int32; barrier, poll before and after completion, join, and the
    object helpers."""
    import torch
    import horovod_tpu_torch as hvd
    checked = []
    g = torch.Generator().manual_seed(8)
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        x = (torch.randn(8, 4, generator=g) * 4).to(device, dt)
        tag = str(dt)[6:]
        handles = [hvd.allreduce_async(x, op=op, name=f"{op.name}.{tag}")
                   for op in (hvd.Sum, hvd.Min, hvd.Max, hvd.Product)]
        pairs = [(f"allreduce_async_{h.name}", hvd.synchronize(h), x)
                 for h in handles]
        pairs += [
            ("allreduce_average_scaled", hvd.allreduce(
                x, op=hvd.Average, prescale_factor=2.0,
                postscale_factor=0.5), x),
            ("allreduce_legacy_average", hvd.allreduce(x, average=True), x),
            ("grouped_allreduce", hvd.grouped_allreduce([x, x[0]])[1], x[0]),
            ("allgather_ragged", hvd.allgather(x[:3]), x[:3]),
            ("alltoall_splits", hvd.alltoall(x, splits=[8]), x),
            ("alltoall_even", hvd.alltoall(x), x),
            ("broadcast", hvd.broadcast(x, 0), x),
            ("allreduce_in_step", hvd.allreduce(x, op=hvd.Sum, axis="data"),
             x)]
        if dt.is_floating_point:
            pairs.append(("allreduce_adasum", hvd.allreduce(
                x, op=hvd.Adasum), x))
        for name, got, want in pairs:
            if got.dtype != want.dtype or got.device != x.device or \
                    not bool(torch.equal(got, want)):
                raise AssertionError(f"frontend: eager {name} {tag} differs "
                                     "from its world-1 value")
            checked.append(f"{name}/{tag}")
    hvd.barrier()
    # the card is kept busy: the op cannot have completed yet
    busy_wait_card(50.0)
    h = hvd.allreduce_async(torch.ones(1 << 20, device=device), name="poll")
    before = hvd.poll(h)
    out = hvd.synchronize(h)
    torch.cuda.synchronize()
    after = hvd.poll(h)
    if before or not after or not bool((out == 1).all()):
        raise AssertionError(f"frontend: poll {before} before and {after} "
                             "after completion")
    last = hvd.join()
    if last != -1:
        raise AssertionError(f"frontend: join() gave {last} at world 1")
    avg = hvd.metric_average(torch.tensor(2.5, device=device))
    obj = {"epoch": 3, "lr": [0.1, 0.01], "name": "frontend"}
    got_obj = hvd.broadcast_object(obj, 0)
    gathered = hvd.allgather_object(obj)
    if float(avg) != 2.5 or got_obj != obj or gathered != [obj]:
        raise AssertionError(f"frontend: metric_average {avg}, "
                             f"broadcast_object {got_obj}, allgather_object "
                             f"{gathered}")
    checked += ["barrier", "poll", "join", "metric_average",
                "broadcast_object", "allgather_object"]
    return checked, {"poll_before": before, "poll_after": after,
                     "join": last}


def eager_latency(device):
    """Median wall time (ms) of ``synchronize(allreduce_async(x))`` until
    the card is done, for a 4-byte and a 64 MiB fp32 tensor, beside the
    in-step allreduce of the same tensor on the default group: the cost of
    the name negotiation."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import collectives as c
    out = {}
    for label, numel, iters in (
            ("4B", 1, FRONT["small_iters"]),
            ("64MiB", FRONT["big_bytes"] // 4, FRONT["big_iters"])):
        x = torch.ones(numel, device=device)
        for name, fn in (
                ("eager", lambda: hvd.synchronize(hvd.allreduce_async(
                    x, op=hvd.Sum, name="latency"))),
                ("in_step", lambda: c.allreduce(x, op=c.Sum))):
            times = []
            for i in range(iters + 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i >= 2:  # the first two set up the communicator
                    times.append((time.perf_counter() - t0) * 1e3)
            out[f"{name}_{label}_ms"] = statistics.median(times)
    return out


def frontend_gpt(device):
    """GPT-2 small as a user writes the loop: broadcast_parameters,
    DistributedOptimizer(AdamW, bf16 wire, two backward passes per step),
    broadcast_optimizer_state, FRONT["micro"] microsteps on two fixed
    batches. The loss must be finite and fall; every kernel launch 12
    times per microstep; the parameters stay as they were after each
    microstep off the boundary. Then, from the same weights and batch, one
    DistributedOptimizer(AdamW) step equals one make_train_step step, and
    both are timed."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.gpt import GptSmall, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import dp
    base = GptSmall(dtype=torch.bfloat16)
    base.reset_parameters(torch.Generator().manual_seed(0))
    state = {k: v.to(device) for k, v in base.state_dict().items()}
    layers = len(base.blocks)
    del base
    gen = torch.Generator().manual_seed(1)
    batches = [torch.randint(0, 50257, (MAIN["b"], MAIN["t"]),
                             generator=gen).to(device) for _ in range(2)]

    def build(bpps=FRONT["bpps"], compression=hvd.Compression.bf16):
        with torch.device(device):
            model = GptSmall(dtype=torch.bfloat16)
        model.load_state_dict(state)
        inner = torch.optim.AdamW(model.parameters(), lr=FRONT["lr"],
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=FRONT["weight_decay"])
        return model, inner, hvd.DistributedOptimizer(
            inner, compression=compression, backward_passes_per_step=bpps)

    model, _, opt = build()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    losses, micro_ms, unchanged = [], [], 0
    for k in range(FRONT["micro"]):
        before = [p.detach().clone() for p in model.parameters()] \
            if k % FRONT["bpps"] == 0 else None
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model, batches[k % 2])[0]
        loss.backward()
        opt.step()
        losses.append(loss.item())  # waits for the microstep
        micro_ms.append((time.perf_counter() - t0) * 1e3)
        if before is not None:
            if not all(torch.equal(a, p) for a, p in
                       zip(before, model.parameters())):
                raise AssertionError(f"frontend: microstep {k} off the "
                                     "boundary moved the parameters")
            unchanged += 1
    counts = fa.launch_counts()
    del model, opt, before
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"frontend: non-finite loss {losses}")
    # the same batch comes back every second microstep
    if not (losses[-2] < losses[0] and losses[-1] < losses[1]):
        raise AssertionError(f"frontend: loss did not fall {losses}")
    want = layers * FRONT["micro"]
    if counts != {k: want for k in counts}:
        raise AssertionError(f"frontend: launches {counts}, want {want} "
                             "each")
    # one DistributedOptimizer step against one make_train_step step
    model_a, _, opt_a = build(bpps=1, compression=hvd.Compression.none)
    opt_a.zero_grad(set_to_none=True)
    lm_loss(model_a, batches[0])[0].backward()
    opt_a.step()
    with torch.device(device):
        model_b = GptSmall(dtype=torch.bfloat16)
    model_b.load_state_dict(state)
    step_b = dp.make_train_step(model_b, lm_loss, torch.optim.AdamW(
        model_b.parameters(), lr=FRONT["lr"], betas=(0.9, 0.999), eps=1e-8,
        weight_decay=FRONT["weight_decay"]))
    step_b(batches[0]).loss.item()
    diff = 0.0
    for (name, a), b in zip(model_a.named_parameters(),
                            model_b.parameters()):
        diff = max(diff, close(f"frontend: DistributedOptimizer vs "
                               f"make_train_step {name}", a.detach(),
                               b.detach(), 1e-6, 0.0)[0])
    del model_a, opt_a, model_b, step_b
    torch.cuda.empty_cache()
    # make_train_step with the loop's options, timed the same way
    with torch.device(device):
        model_c = GptSmall(dtype=torch.bfloat16)
    model_c.load_state_dict(state)
    step_c = dp.make_train_step(model_c, lm_loss, torch.optim.AdamW(
        model_c.parameters(), lr=FRONT["lr"], betas=(0.9, 0.999), eps=1e-8,
        weight_decay=FRONT["weight_decay"]),
        compression=hvd.Compression.bf16)
    step_ms = []
    for i in range(FRONT["step_iters"] + 1):
        t0 = time.perf_counter()
        step_c(batches[i % 2]).loss.item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    del model_c, step_c
    torch.cuda.empty_cache()
    boundary = micro_ms[3::2]  # after the first update
    accumulate = micro_ms[2::2]
    return counts, {
        "model": "GptSmall", "batch": MAIN["b"], "seq": MAIN["t"],
        "optimizer": f"DistributedOptimizer(AdamW(lr={FRONT['lr']}, "
                     f"weight_decay={FRONT['weight_decay']}), "
                     f"compression=bf16, backward_passes_per_step="
                     f"{FRONT['bpps']})",
        "microsteps": FRONT["micro"], "losses": losses,
        "microstep_ms": micro_ms,
        "accumulate_microstep_ms": statistics.mean(accumulate),
        "boundary_microstep_ms": statistics.mean(boundary),
        "unchanged_off_boundary": unchanged, "launches": counts,
        "dist_opt_vs_make_train_step_max_abs_err": diff,
        "make_train_step_ms": step_ms,
        "make_train_step_steady_ms": statistics.mean(step_ms[1:])}


def frontend_mnist(device):
    """BASELINE config 1: MnistConvNet at batch 64 through
    DistributedOptimizer(SGD(momentum=0.9)), FRONT["mnist_steps"] steps on
    one fixed batch from seed 0; the loss must fall."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import MnistConvNet
    model = MnistConvNet()
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=FRONT["mnist_lr"], momentum=0.9))
    rs = np.random.RandomState(0)
    n = FRONT["mnist_batch"]
    images = torch.tensor(rs.rand(n, 28, 28, 1), dtype=torch.float32,
                          device=device)
    labels = torch.tensor(rs.randint(0, 10, n), device=device)
    losses = []
    for _ in range(FRONT["mnist_steps"]):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        losses.append(float(hvd.metric_average(loss.detach())))
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"frontend: MNIST loss did not fall {losses}")
    return {"model": "MnistConvNet", "batch": n,
            "optimizer": f"DistributedOptimizer(SGD(lr={FRONT['mnist_lr']}, "
                         "momentum=0.9))",
            "steps": FRONT["mnist_steps"], "losses": losses}


def frontend(device, card, gpt_flops):
    """The frontend phase: the eager ops, their latency, GPT-2 small and
    MNIST through DistributedOptimizer, at world 1 on NCCL. ``gpt_flops``
    is one forward and backward of GPT-2 small at the train phase's batch
    (``step_flops``): a step of ``FRONT["bpps"]`` microsteps does it that
    many times."""
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        checked, flags = eager_ops_check(device)
        latency = eager_latency(device)
        counts, gpt = frontend_gpt(device)
        mnist = frontend_mnist(device)
    finally:
        hvd.shutdown()
    step_s = ((FRONT["bpps"] - 1) * gpt["accumulate_microstep_ms"] +
              gpt["boundary_microstep_ms"]) / 1e3
    tokens = MAIN["b"] * MAIN["t"]
    gpt["tokens_per_s"] = FRONT["bpps"] * tokens / step_s
    gpt["mfu"] = mfu_entry(gpt_flops, tokens, gpt["tokens_per_s"])
    return counts, {"phase": "frontend", "nvidia_smi": card,
                    "backend": "nccl", "world_size": 1,
                    "eager_checked": len(checked), "eager_cases": checked,
                    **flags, "eager_latency": latency, "gpt": gpt,
                    "mnist": mnist}


# ---------------------------------------------------------------------------
# the BERT-Large path (BASELINE config 3: BERT-Large pretraining with tensor
# fusion and fp16 gradient compression), at seq 512 as in phase-2 pretraining

BERT = dict(batch=BERT_SHAPE["b"], seq=BERT_SHAPE["t"], vocab=30522,
            lr=1e-4, weight_decay=1e-4,  # optax.adamw(1e-4), bench.py:230
            bucket_bytes=64 << 20,  # HOROVOD_FUSION_THRESHOLD's default
            small_bucket_bytes=8 << 20)
# option set -> make_train_step options
BERT_SETS = (
    ("fp16", dict(compression="fp16")),
    ("fp16_bucketed", dict(compression="fp16",
                           bucket_bytes=BERT["bucket_bytes"])),
    ("int8_zero1_bucketed", dict(compression="int8", sharded_update=True,
                                 bucket_bytes=BERT["bucket_bytes"])),
)


def bert_model(state, device):
    """BertLarge on ``device`` (bf16 compute, fp32 parameters, attention
    on the flash kernels, non-causal) holding the weights ``state``."""
    import torch
    from horovod_tpu_torch.models import BertLarge
    with torch.device(device):
        model = BertLarge(dtype=torch.bfloat16, use_flash=True,
                          max_len=BERT["seq"])
    model.load_state_dict(state)
    return model


def bert_step(model, opts):
    """make_train_step of ``model`` with AdamW and the options ``opts``
    (the compression by name); a ZeRO-1 optimizer with sharded_update."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import mlm_loss
    from horovod_tpu_torch.parallel import dp, zero
    kw = dict(opts)
    kw["compression"] = getattr(hvd.Compression,
                                kw.get("compression", "none"))

    def adamw(ps):
        return torch.optim.AdamW(ps, lr=BERT["lr"],
                                 weight_decay=BERT["weight_decay"])
    if kw.get("sharded_update"):
        opt = zero.sharded_optimizer(model, adamw,
                                     bucket_bytes=kw.get("bucket_bytes", 0))
    else:
        opt = adamw(model.parameters())
    return dp.make_train_step(model, mlm_loss, opt, **kw)


def bert_exchange(model, grads, **opts):
    """The gradient exchange of a train step with ``opts`` applied to
    ``grads`` (one per parameter) without a backward: every unit is
    launched in unit order, as after a backward in which no hook fired."""
    step = bert_step(model, opts)
    params = list(model.parameters())
    for p, g in zip(params, grads):
        p.grad = g
    step.exchange.begin()
    out = [None] * len(params)
    for _, idxs, reduced in step.exchange.finish():
        for i, r in zip(idxs, reduced):
            out[i] = r
    for p in params:
        p.grad = None
    return out


def bert_grad_checks(state, batch, device):
    """On one set of the first step's gradients: the bucketed exchange
    equals the fused one bit for bit (fp32 and fp16 wire), int8 at two
    bucket bounds gives the same bits, and Adasum of one replica is its
    input; then one ZeRO-1 step (no compression) against one replicated
    step from the same weights, within rtol 1e-5, and one step with 64 MiB
    buckets launched from the gradient hooks against one unbucketed step
    (fp16 wire), bit for bit when the backward is deterministic."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import mlm_loss
    model = bert_model(state, device)
    runs = []
    for _ in range(2):  # twice: is the backward deterministic?
        model.zero_grad(set_to_none=True)
        mlm_loss(model, batch)[0].backward()
        runs.append([p.grad for p in model.parameters()])
        model.zero_grad(set_to_none=True)
    grads = runs[0]
    deterministic = all(torch.equal(a, b) for a, b in zip(*runs))
    del runs
    res = {"backward_deterministic": deterministic}

    def same_bits(name, a, b):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"bert: {name} differ")
        res[name] = True
    big, small = BERT["bucket_bytes"], BERT["small_bucket_bytes"]
    for wire in ("none", "fp16"):
        same_bits(f"bucketed_equals_fused_{wire}",
                  bert_exchange(model, grads, compression=wire),
                  bert_exchange(model, grads, compression=wire,
                                bucket_bytes=big))
    int8 = bert_exchange(model, grads, compression="int8", bucket_bytes=big)
    same_bits("int8_same_bits_64mib_8mib", int8,
              bert_exchange(model, grads, compression="int8",
                            bucket_bytes=small))
    res["int8_max_abs_err"] = max(float((a - g).abs().max())
                                  for a, g in zip(int8, grads))
    del int8
    same_bits("adasum_is_the_identity",
              bert_exchange(model, grads, op=hvd.Adasum), grads)
    del grads, model
    torch.cuda.empty_cache()
    stepped, early = {}, {}
    for name, opts in (("replicated", {}),
                       ("zero1", dict(sharded_update=True)),
                       ("fp16", dict(compression="fp16")),
                       ("fp16_bucketed", dict(compression="fp16",
                                              bucket_bytes=big))):
        model = bert_model(state, device)
        step = bert_step(model, opts)
        step(batch).loss.item()
        early[name] = step.exchange.early_launches
        stepped[name] = {n: p.detach().cpu()
                         for n, p in model.named_parameters()}
        del model, step
        torch.cuda.empty_cache()
    res["zero1_vs_replicated_max_abs_err"] = max(
        close(f"bert: zero1 vs replicated {n}", stepped["zero1"][n], want,
              1e-5, 1e-7)[0] for n, want in stepped["replicated"].items())
    # one real step with the buckets launched from the gradient hooks
    # against the unbucketed step from the same weights
    if not early["fp16_bucketed"] > 0:
        raise AssertionError("bert: the hook-driven step launched no bucket "
                             "before the backward ended")
    if deterministic:
        same_bits("hook_driven_step_equals_fused_fp16",
                  list(stepped["fp16_bucketed"].values()),
                  list(stepped["fp16"].values()))
    return res


def bert(device, profile_dir=None, profile=False):
    """The third main path: BERT-Large at seq 512 through init() on NCCL
    and make_train_step, STEPS steps under each option set of BERT_SETS
    from the same weights, after the gradient checks."""
    import gc
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import BertLarge
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import dp
    hvd.init()
    lines, profs, path_counts = [], [], {k: 0 for k in NAMES}
    try:
        base = BertLarge(dtype=torch.bfloat16, max_len=BERT["seq"])
        base.reset_parameters(torch.Generator().manual_seed(0))
        state = base.state_dict()
        n_params = sum(p.numel() for p in base.parameters())
        layers = len(base.blocks)
        del base
        n, t = BERT["batch"] * hvd.size(), BERT["seq"]
        rs = np.random.RandomState(0)
        batch = dp.shard_batch({k: torch.tensor(rs.randint(
            0, BERT["vocab"], (n, t))) for k in ("tokens", "labels")})
        batch = {k: v.to(hvd.device()) for k, v in batch.items()}
        checks = bert_grad_checks(state, batch, device)
        from horovod_tpu_torch.models.transformer import mlm_loss
        est = step_flops(mlm_loss, bert_model(state, device), batch)
        gc.collect()
        torch.cuda.empty_cache()
        for name, opts in BERT_SETS:
            model = bert_model(state, device)
            step = bert_step(model, opts)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
            losses, step_ms = [], []
            for _ in range(STEPS):
                t0 = time.perf_counter()
                out = step(batch)
                losses.append(out.loss.item())  # waits for the step
                step_ms.append((time.perf_counter() - t0) * 1e3)
            counts = fa.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            early = step.exchange.early_launches
            units = len(step.exchange.units)
            if profile:
                profs.append(dict(profile_step(step, batch, profile_dir,
                                               f"bert_{name}.json"),
                                  model="BertLarge", option_set=name))
            del model, step, out
            gc.collect()
            torch.cuda.empty_cache()
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"bert {name}: non-finite loss {losses}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"bert {name}: loss did not fall "
                                     f"{losses}")
            want = layers * STEPS
            if counts != {k: want for k in counts}:
                raise AssertionError(f"bert {name}: launches {counts}, want "
                                     f"{want} each")
            if opts.get("bucket_bytes") and not early > 0:
                raise AssertionError(f"bert {name}: no bucket launched "
                                     "before the backward ended")
            for k in NAMES:
                path_counts[k] += counts[k]
            steady = step_ms[1:]
            mean_ms = sum(steady) / len(steady)
            lines.append({
                "phase": "bert", "option_set": name, "options": opts,
                "model": "BertLarge", "params": n_params,
                "batch": BERT["batch"], "seq": t, "dtype": "bfloat16",
                "param_dtype": "float32",
                "optimizer": f"AdamW(lr={BERT['lr']}, "
                             f"weight_decay={BERT['weight_decay']})",
                "steps": STEPS, "losses": losses, "step_ms": step_ms,
                "steady_step_ms": mean_ms,
                "tokens_per_s": BERT["batch"] * t / (mean_ms / 1e3),
                "mfu": mfu_entry(est, BERT["batch"] * t,
                                 BERT["batch"] * t / (mean_ms / 1e3)),
                "peak_mem_bytes": peak, "launches": counts,
                "buckets": units,
                "buckets_launched_before_backward_end": early,
                "backend": "nccl", "world_size": 1})
        lines[0].update(checks)
        same = lines[1]["losses"] == lines[0]["losses"]
        lines[1]["losses_equal_to_fused"] = same
        if checks["backward_deterministic"] and not same:
            raise AssertionError(
                f"bert: the bucketed set's losses {lines[1]['losses']} are "
                f"not the fused set's {lines[0]['losses']}")
    finally:
        hvd.shutdown()
    return path_counts, lines, profs


RESNET = dict(batch=128, image=224, classes=1000, lr=0.05, momentum=0.9)
# one step of ResNet-50 is about 3 x 4.1 GMAC x 2 FLOP per image: no card
# does it faster than at the bf16 peak, so a faster reading did not wait
RESNET_FLOP_PER_IMAGE = 3 * 4.1e9 * 2


def resnet(device, profile_dir=None, profile=False):
    """The second main path: ResNet-50 through init() on NCCL and
    make_stateful_train_step at the reference example's configuration."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import dp
    hvd.init()
    try:
        model = ResNet50(num_classes=RESNET["classes"],
                         dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(0))
        n_params = sum(p.numel() for p in model.parameters())
        opt = torch.optim.SGD(model.parameters(), lr=RESNET["lr"],
                              momentum=RESNET["momentum"])

        def loss_fn(m, b):
            return F.cross_entropy(m(b["image"], train=True),
                                   b["label"]), {}
        n, sz = RESNET["batch"] * hvd.size(), RESNET["image"]
        rs = np.random.RandomState(0)
        batch = dp.shard_batch({
            "image": torch.tensor(rs.rand(n, sz, sz, 3)).to(torch.bfloat16),
            "label": torch.tensor(rs.randint(0, RESNET["classes"], n))})
        batch = {k: v.to(hvd.device()) for k, v in batch.items()}
        est = step_flops(loss_fn, model.to(hvd.device()), batch)
        step = dp.make_stateful_train_step(model, loss_fn, opt)
        before = {k: b.clone() for k, b in model.named_buffers()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        losses, step_ms = [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            out = step(batch)
            losses.append(out.loss.item())  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = fa.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        after = {k: b.clone() for k, b in model.named_buffers()}
        prof = profile_step(step, batch, profile_dir,
                            "resnet_step.json") if profile else None
    finally:
        hvd.shutdown()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"resnet: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"resnet: loss did not fall {losses}")
    for name, b in after.items():
        if b.dtype != torch.float32 or not bool(torch.isfinite(b).all()) \
                or bool(torch.equal(b, before[name])):
            raise AssertionError(f"resnet: running statistic {name} is "
                                 f"{b.dtype}, not finite or did not move")
    if any(counts.values()):
        raise AssertionError(f"resnet: flash kernels launched {counts}")
    steady = step_ms[1:]
    mean_ms = sum(steady) / len(steady)
    bound_ms = RESNET_FLOP_PER_IMAGE * RESNET["batch"] / \
        PEAK_FLOPS["bfloat16"] * 1e3
    if mean_ms < bound_ms:
        raise AssertionError(f"resnet: {mean_ms} ms per step is below the "
                             f"{bound_ms} ms bound: the timing did not wait")
    return counts, prof, {
        "phase": "resnet", "model": "ResNet50", "params": n_params,
        "batch": RESNET["batch"], "image": [RESNET["image"]] * 2 + [3],
        "layout": "NHWC", "dtype": "bfloat16", "param_dtype": "float32",
        "optimizer": "SGD(lr=0.05, momentum=0.9)", "steps": STEPS,
        "losses": losses, "step_ms": step_ms, "steady_step_ms": mean_ms,
        "images_per_s": RESNET["batch"] / (mean_ms / 1e3),
        "mfu": mfu_entry(est, RESNET["batch"],
                         RESNET["batch"] / (mean_ms / 1e3)),
        "peak_mem_bytes": peak, "running_stats_moved": len(after),
        "flash_launches": counts, "bound_step_ms": bound_ms,
        "backend": "nccl", "world_size": 1}


# ---------------------------------------------------------------------------
# MFU of the training paths (profiler/flops.py, profiler/mfu.py)


def step_flops(loss_fn, model, batch):
    """``train_step_flops`` of one forward and backward of ``loss_fn(model,
    batch)`` (aten ops plus the flash kernels' share), on a model that no
    train step's hooks watch yet; it leaves no gradient behind. Its flash
    launches are not a path's: count them outside a counted window."""
    from horovod_tpu_torch.profiler import flops

    def run():
        loss_fn(model, batch)[0].backward()
        model.zero_grad(set_to_none=True)
    return flops.train_step_flops(run, ())


def mfu_entry(est, items, items_per_s) -> dict:
    """The port's ``mfu_report`` for a path: the FLOPs ``est`` of one
    forward and backward of ``items`` items (tokens, images), at
    ``items_per_s``, over the card's bf16 peak. A value outside (0, 1]
    fails the run."""
    from horovod_tpu_torch.profiler import flops, mfu
    per_item = flops.FlopsEstimate(est.flops / items, est.source,
                                   est.detail)
    rep = mfu.mfu_report(items_per_s, per_item, mfu.peak_tflops())
    if not 0 < rep["mfu"] <= 1:
        raise AssertionError(f"mfu {rep} is outside (0, 1]")
    return rep


# ---------------------------------------------------------------------------
# the remaining parallelism (sequence, tensor, pipeline, expert axes) at
# GPT-2 small's widths. Each function runs at the world of the job's mesh
# (1 here, 4 in tests/test_torch_cuda_dist.py), computes the single-card
# result on its own card from the same seeded inputs, and compares this
# rank's part of it.

PAR = dict(b=1, t=32768, t_plain=8192, h=12, d=64)  # long-context attention
RING_SHARD = dict(b=1, t=8192, h=12, d=64)  # one of 4 ranks' ring shard
TP_MLP = dict(batch=8, seq=1024, hidden=768, mlp=3072)
PIPE = dict(batch=8, seq=1024, n_micro=8, layers=12)
# cf 1.25 keeps every token at these sizes; cf_drop 0.5 (half the mean
# load per expert) must drop some, so the dropped tokens' zeros are checked
MOE = dict(tokens=8192, hidden=768, experts=8, mlp=3072, cf=1.25,
           cf_drop=0.5)
FP32_FWD, FP32_GRAD = (2e-4, 2e-5), (2e-3, 2e-4)
BF16_TOL = (2e-2, 1e-6, 2e-2, 1e-2)  # rtol, atol, row atol, normwise


def _shard(x, dim, rank, n):
    per = x.shape[dim] // n
    return x.narrow(dim, rank * per, per)


def _counted(run, counts):
    """``run()`` once with the launch counters from 0, its launches added
    to ``counts``: the result, this run's launches and peak memory."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    got = fa.launch_counts()
    for k, v in got.items():
        counts[k] += v
    return out, got, torch.cuda.max_memory_allocated()


def _compare(name, got, want, tol) -> dict:
    """``close`` over the keys of ``want``: {key: [max abs, normwise]}."""
    return {k: list(close(f"{name}/{k}", got[k].detach(), want[k].detach(),
                          *tol)) for k in want}


def _par_time(run) -> dict:
    ts = [time_ms(run, 1, warmup=1) for _ in range(TURNS)]
    return {"ms": statistics.median(ts), "ms_turns": ts}


def par_attention(device, counts, kind, use_flash, t):
    """Ring or Ulysses attention over ``seq`` at total length ``t`` (bf16,
    causal, GPT-2 small's 12 heads of 64), the loss sum(o * w) for a fixed
    random w; against one ``flash_attention`` call (flash) or
    ``dense_attention`` (plain) on the full sequence: at world 1 the flash
    paths bit-equal, else within bf16 tolerances."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import collectives as c, sp
    n, r = c.axis_size("seq"), c.axis_rank("seq")
    g = torch.Generator().manual_seed(7)
    full = [torch.randn(PAR["b"], t, PAR["h"], PAR["d"], generator=g)
            .to(device, torch.bfloat16) for _ in range(4)]
    mine = [_shard(x, 1, r, n).detach().requires_grad_(i < 3)
            for i, x in enumerate(full)]
    fn = sp.ring_attention if kind == "ring" else sp.ulysses_attention

    def run():
        o = fn(*mine[:3], causal=True, use_flash=use_flash)
        grads = torch.autograd.grad((o * mine[3]).float().sum(), mine[:3])
        return dict(zip(("o", "dq", "dk", "dv"), (o,) + grads))
    got, launches, peak = _counted(run, counts)
    ref_in = [x.detach().requires_grad_(True) for x in full[:3]]
    ref_fn = fa.flash_attention if use_flash else fa.dense_attention
    o = ref_fn(*ref_in, causal=True)
    grads = torch.autograd.grad((o * full[3]).float().sum(), ref_in)
    want = {k: _shard(x, 1, r, n) for k, x in
            zip(("o", "dq", "dk", "dv"), (o,) + grads)}
    del o, grads, ref_in
    name = f"{kind}_{'flash' if use_flash else 'plain'}"
    entry = {"name": name, "shape": [PAR["b"], t, PAR["h"], PAR["d"]],
             "dtype": "bfloat16", "causal": True, "world": n,
             "comparison": ref_fn.__name__, "flash_launches": launches,
             "peak_mem_bytes": peak}
    if use_flash and n == 1:
        same = {k: bool(torch.equal(got[k], want[k])) for k in want}
        if not all(same.values()):
            raise AssertionError(f"parallel/{name}: not bit-equal to one "
                                 f"flash_attention call at world 1: {same}")
        entry.update(tolerance="bit-equal",
                     err={k: [0.0, 0.0] for k in want})
    else:
        entry.update(tolerance=BF16_TOL,
                     err=_compare(f"parallel/{name}", got, want, BF16_TOL))
    del got, want
    torch.cuda.empty_cache()
    entry.update(_par_time(run))
    return entry


def par_tp(device, counts):
    """``tp_mlp`` over ``model`` (fp32, x [8, 1024, 768], W [768, 3072]
    and [3072, 768] sliced as the reference's PartitionSpecs) against the
    dense MLP, forward and gradients; ``tp_mlp_inference`` with the fp32
    wire and with the int8 wire, the int8 one held to the quantizer's own
    bound: half a step (max|block| / 127 / 2) per quantization, bounded
    with the tensors' maxima by (sum over ranks of max|partial| + max|y|)
    / 127, which is the reference's 2 max|x| / 127 at world 1."""
    import torch
    from horovod_tpu_torch import Compression
    from horovod_tpu_torch.parallel import collectives as c, tp
    n, r = c.axis_size("model"), c.axis_rank("model")
    g = torch.Generator().manual_seed(8)
    hid, mlp = TP_MLP["hidden"], TP_MLP["mlp"]
    shape = (TP_MLP["batch"], TP_MLP["seq"], hid)
    x = torch.randn(*shape, generator=g).to(device)
    w_in = (torch.randn(hid, mlp, generator=g) * hid ** -0.5).to(device)
    w_out = (torch.randn(mlp, hid, generator=g) * mlp ** -0.5).to(device)
    w = torch.randn(*shape, generator=g).to(device)
    mine = [x.clone().requires_grad_(True),
            _shard(w_in, 1, r, n).clone().requires_grad_(True),
            _shard(w_out, 0, r, n).clone().requires_grad_(True)]

    def run():
        y = tp.tp_mlp(*mine)
        grads = torch.autograd.grad((y * w).sum(), mine)
        return dict(zip(("y", "dx", "dw_in", "dw_out"), (y,) + grads))
    got, launches, peak = _counted(run, counts)
    ref = [v.clone().requires_grad_(True) for v in (x, w_in, w_out)]
    y = tp.gelu_tanh(ref[0] @ ref[1]) @ ref[2]
    dx, dwi, dwo = torch.autograd.grad((y * w).sum(), ref)
    y = y.detach()
    err = _compare("parallel/tp_mlp", got, {"y": y}, FP32_FWD)
    err.update(_compare("parallel/tp_mlp", got, {
        "dx": dx, "dw_in": _shard(dwi, 1, r, n),
        "dw_out": _shard(dwo, 0, r, n)}, FP32_GRAD))
    with torch.no_grad():
        fp32 = tp.tp_mlp_inference(x, *mine[1:])
        int8 = tp.tp_mlp_inference(x, *mine[1:],
                                   compression=Compression.int8)
        partial_max = sum(
            float((tp.gelu_tanh(x @ _shard(w_in, 1, s, n)) @
                   _shard(w_out, 0, s, n)).abs().max()) for s in range(n))
    bound = (partial_max + float(y.abs().max())) / 127
    err["inference_fp32"] = list(close("parallel/tp_mlp_inference fp32",
                                       fp32, y, *FP32_FWD))
    err["inference_int8"] = list(close("parallel/tp_mlp_inference int8",
                                       int8, y, 0.0, bound))
    del got, ref, dx, dwi, dwo
    entry = {"name": "tp_mlp", "x": list(shape), "w_in": [hid, mlp],
             "w_out": [mlp, hid], "dtype": "float32", "world": n,
             "tolerance": {"fwd": FP32_FWD, "grad": FP32_GRAD,
                           "int8_atol": bound},
             "comparison": "dense MLP", "err": err,
             "flash_launches": launches, "peak_mem_bytes": peak}
    entry.update(_par_time(run))
    return entry


def par_pipeline(device, counts):
    """``pipeline_apply`` over ``pipe``: GPT-2 small's 12 causal blocks
    (flax's initializers from seed 9) split evenly into the stages (one
    stage of 12 at world 1), batch 8 x seq 1024 of bf16 activations,
    n_micro 8, the loss sum(out * w); against the 12 blocks applied in
    order to the whole batch: outputs and the stage parameters'
    gradients, within bf16 tolerances."""
    import copy
    import torch
    from horovod_tpu_torch.models.transformer import (EncoderBlock,
                                                      reset_blocks_)
    from horovod_tpu_torch.parallel import collectives as c, pp
    n, r = c.axis_size("pipe"), c.axis_rank("pipe")
    blocks = torch.nn.ModuleList(
        EncoderBlock(768, 12, 3072, torch.bfloat16, use_flash=True,
                     causal=True) for _ in range(PIPE["layers"]))
    reset_blocks_(blocks, torch.Generator().manual_seed(9))
    blocks.to(device)
    per = len(blocks) // n
    mine = blocks[r * per:(r + 1) * per]
    stage = torch.nn.Sequential(*copy.deepcopy(list(mine)))
    g = torch.Generator().manual_seed(10)
    shape = (PIPE["batch"], PIPE["seq"], 768)
    x = torch.randn(*shape, generator=g).to(device, torch.bfloat16)
    w = torch.randn(*shape, generator=g).to(device, torch.bfloat16)
    params = list(stage.parameters())

    def run():
        out = pp.pipeline_apply(lambda m, h: m(h), stage, x,
                                n_micro=PIPE["n_micro"])
        grads = torch.autograd.grad((out * w).float().sum(), params)
        return out, grads
    (out, grads), launches, peak = _counted(run, counts)
    h = x
    for blk in blocks:
        h = blk(h)
    ref_grads = torch.autograd.grad((h * w).float().sum(),
                                    list(mine.parameters()))
    err = _compare("parallel/pipeline", {"out": out}, {"out": h.detach()},
                   BF16_TOL)
    # the stage's gradients as one vector, each element within bf16
    # tolerance of the vector's largest: some have a true value of zero
    # (the key bias: softmax ignores a shift shared by a row's scores)
    # and are rounding noise of either side's bf16 products
    got_g = torch.cat([gr.flatten() for gr in grads])
    want_g = torch.cat([gr.flatten() for gr in ref_grads])
    grad_atol = BF16_TOL[2] * float(want_g.abs().max())
    err["stage_param_grads"] = list(close(
        "parallel/pipeline/grad", got_g, want_g, BF16_TOL[0], grad_atol,
        0.0, BF16_TOL[3]))
    del out, grads, h, ref_grads, got_g, want_g
    entry = {"name": "pipeline", "stages": n, "blocks_per_stage": per,
             "x": list(shape), "dtype": "bfloat16",
             "n_micro": PIPE["n_micro"], "world": n,
             "tolerance": {"out": BF16_TOL,
                           "grads": [BF16_TOL[0], grad_atol, 0.0,
                                     BF16_TOL[3]]},
             "comparison": "blocks in order",
             "err": err, "flash_launches": launches,
             "peak_mem_bytes": peak}
    entry.update(_par_time(run))
    return entry


def par_moe(device, counts, cf=MOE["cf"], must_drop=False):
    """``moe_layer`` over ``expert`` (fp32, 8192 tokens of 768 in all, 8
    experts of hidden 3072 split evenly over the ranks, capacity factor
    ``cf``) against the dense per-token reference (every expert on every
    token, top-1 selected and scaled by its gate): equal on the tokens the
    routing keeps, zero on those it drops; gradients of sum(out * w) with
    the dense reference masked the same way (w_gate's summed over the
    ranks, as the reference's test psums it). With ``must_drop``, the
    routing must drop some token."""
    import torch
    from horovod_tpu_torch.parallel import collectives as c, ep, tp
    n, r = c.axis_size("expert"), c.axis_rank("expert")
    g = torch.Generator().manual_seed(11)
    t, hid, e, mlp = MOE["tokens"], MOE["hidden"], MOE["experts"], \
        MOE["mlp"]
    x = torch.randn(t, hid, generator=g).to(device)
    w_gate = (torch.randn(hid, e, generator=g) * hid ** -0.5).to(device)
    w_in = (torch.randn(e, hid, mlp, generator=g) * hid ** -0.5).to(device)
    w_out = (torch.randn(e, mlp, hid, generator=g) * mlp ** -0.5) \
        .to(device)
    w = torch.randn(t, hid, generator=g).to(device)
    mine = [_shard(x, 0, r, n).clone().requires_grad_(True),
            w_gate.clone().requires_grad_(True),
            _shard(w_in, 0, r, n).clone().requires_grad_(True),
            _shard(w_out, 0, r, n).clone().requires_grad_(True)]
    w_mine = _shard(w, 0, r, n)

    def run():
        out = ep.moe_layer(*mine, capacity_factor=cf)
        grads = torch.autograd.grad((out * w_mine).sum(), mine)
        return dict(zip(("out", "dx", "dw_gate", "dw_in", "dw_out"),
                        (out,) + grads))
    got, launches, peak = _counted(run, counts)
    got["dw_gate"] = c.allreduce(got["dw_gate"], op=c.Sum, axis="expert")
    # the tokens each source rank's routing keeps, at its own capacity
    cap = max(1, int(cf * (t // n) / e))
    with torch.no_grad():
        keep = torch.cat([
            ep.top1_dispatch(torch.softmax(_shard(x, 0, s, n) @ w_gate, -1),
                             cap)[0].sum((1, 2)) > 0 for s in range(n)])
    dropped = t - int(keep.sum())
    if must_drop and not dropped:
        raise AssertionError(f"parallel/moe: capacity factor {cf} dropped "
                             "no token")
    ref = [v.clone().requires_grad_(True) for v in (x, w_gate, w_in, w_out)]
    gates = torch.softmax(ref[0] @ ref[1], dim=-1)
    act = tp.gelu_tanh(torch.einsum("td,edh->teh", ref[0], ref[2]))
    sel = torch.einsum("teh,ehd->ted", act, ref[3])[
        torch.arange(t, device=device), gates.argmax(-1)]
    dense = sel * (gates.amax(-1) * keep)[:, None]
    grads = torch.autograd.grad((dense * w).sum(), ref)
    kept = _shard(keep, 0, r, n)
    if not bool((got["out"][~kept] == 0).all()):
        raise AssertionError("parallel/moe: a dropped token is not zero")
    err = _compare("parallel/moe", got,
                   {"out": _shard(dense.detach(), 0, r, n)}, FP32_FWD)
    err.update(_compare("parallel/moe", got, {
        "dx": _shard(grads[0], 0, r, n), "dw_gate": grads[1],
        "dw_in": _shard(grads[2], 0, r, n),
        "dw_out": _shard(grads[3], 0, r, n)}, FP32_GRAD))
    del got, ref, gates, act, sel, dense, grads
    torch.cuda.empty_cache()
    entry = {"name": "moe" if cf == MOE["cf"] else f"moe_cf{cf}",
             "tokens": t, "hidden": hid, "experts": e,
             "experts_per_rank": e // n, "expert_hidden": mlp,
             "capacity_factor": cf, "capacity": cap,
             "kept_tokens": t - dropped, "dropped_tokens": dropped,
             "dtype": "float32",
             "world": n, "tolerance": {"fwd": FP32_FWD, "grad": FP32_GRAD},
             "comparison": "dense per-token MoE", "err": err,
             "flash_launches": launches, "peak_mem_bytes": peak}
    entry.update(_par_time(run))
    return entry


def parallel_entries(device, counts) -> list:
    """Every strategy at GPT-2 small's widths, at the job's world: each
    on the mesh axis it runs over, so the job's mesh gives that axis the
    world (here every axis has size 1)."""
    return [par_attention(device, counts, "ring", True, PAR["t"]),
            par_attention(device, counts, "ring", False, PAR["t_plain"]),
            par_attention(device, counts, "ulysses", True, PAR["t"]),
            par_tp(device, counts), par_pipeline(device, counts),
            par_moe(device, counts),
            par_moe(device, counts, MOE["cf_drop"], must_drop=True)]


def parallel(device, card):
    """The parallel phase at world 1 on NCCL."""
    import horovod_tpu_torch as hvd
    counts = {k: 0 for k in NAMES}
    hvd.init()
    try:
        entries = parallel_entries(device, counts)
    finally:
        hvd.shutdown()
    # the rings' and Ulysses' one launch each, the pipeline's blocks on
    # every tick
    want = 2 + PIPE["layers"] * PIPE["n_micro"]
    if counts != {k: want for k in counts}:
        raise AssertionError(f"parallel: launches {counts}, want {want} "
                             "each")
    return counts, {"phase": "parallel", "nvidia_smi": card,
                    "backend": "nccl", "world_size": 1, "entries": entries}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the nvcc logs (and the trace)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra train step after the counted "
                         "ones (torch.profiler)")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from horovod_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    per_lib = _build.build()
    ptxas = {}
    for name in _build.SOURCES:
        log = _build.build_log(name)
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
        if opts.out:
            os.makedirs(opts.out, exist_ok=True)
            with open(os.path.join(opts.out, f"nvcc_{name}.log"), "w") as f:
                f.write(log)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_library_s": per_lib, "ptxas": ptxas})
    resources = kernel_resources()
    emit({"phase": "resources", "kernels": resources})

    max_err = {}
    for case in kernel_cases():
        errs, norms, tols = check_case(case, device)
        emit({"phase": "kernels", "case": case["name"], "max_abs_err": errs,
              "normwise_err": norms,
              "tolerance_rtol_atol_rowatol_norm": tols})
        if case["name"] in MAIN_PATH_CASES:
            for k, e in errs.items():
                max_err[k] = max(max_err.get(k, 0.0), e)
    emit({"phase": "kernels", "case": "autograd_f32",
          "max_abs_err": autograd_check(device)})

    emit({"phase": "parity", "max_abs_err": parity(device)})

    times, sdpa = timing(device)
    emit({"phase": "timing", "shape": MAIN, "dtype": "bfloat16",
          "causal": True, "kernels": times, **sdpa})
    bert_times, bert_sdpa = timing(device, BERT_SHAPE, causal=False)
    emit({"phase": "timing", "shape": BERT_SHAPE, "dtype": "bfloat16",
          "causal": False, "kernels": bert_times, **bert_sdpa})
    # the last of four ranks' ring blocks: its diagonal, and the keys of
    # rank 0, every pair visible
    ring_times = {}
    for key, k_off in (("ring_shard", 3.0), ("ring_shard_offdiag", 0.0)):
        q_off, k_off = 3.0 * RING_SHARD["t"], k_off * RING_SHARD["t"]
        ring_times[key], ring_sdpa = timing(device, RING_SHARD, causal=True,
                                            q_off=q_off, k_off=k_off)
        emit({"phase": "timing", "shape": RING_SHARD, "dtype": "bfloat16",
              "causal": True, "q_offset": q_off, "k_offset": k_off,
              "kernels": ring_times[key], **ring_sdpa})
    emit(crossover(device))

    counts = {}
    counts["gpt"], prof, gpt_flops, train_line = train(device, opts.out,
                                                       opts.profile)
    emit(train_line)
    if prof is not None:
        emit(prof)

    emit(collectives_check(device))
    counts["frontend"], front_line = frontend(device, card, gpt_flops)
    emit(front_line)
    counts["bert"], bert_lines, profs = bert(device, opts.out, opts.profile)
    for line in bert_lines + profs:
        emit(line)
    counts["resnet"], prof, resnet_line = resnet(device, opts.out,
                                                 opts.profile)
    emit(resnet_line)
    if prof is not None:
        emit(dict(prof, model="ResNet50"))
    counts["parallel"], par_line = parallel(device, card)
    emit(par_line)

    kernels = []
    for name in NAMES:
        src, replaces = REPLACES[name]
        t, tb = times[name], bert_times[name]
        res = resources[f"{name}/bfloat16/d{MAIN['d']}"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(c[name] for c in counts.values()),
            "launches_by_path": {path: c[name]
                                 for path, c in counts.items()},
            "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_ms_joint": t["library_ms_joint"],
            "bert_shape": {k: tb[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_ms_joint")},
            **{key: {k: tr[name][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_ms_joint")} for key, tr in ring_times.items()},
            "registers": res["registers"], "smem_bytes": res["smem_bytes"],
            "blocks_per_sm": res["blocks_per_sm"]})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
