#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU (H100).

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit:

    python3 chip_smoke.py [--out DIR] [--profile]

Phases, one JSON line each on stdout; any failure raises and exits non-zero:

1. device    - card name and power limit (nvidia-smi);
2. build     - nvcc builds the three flash-attention kernels from
               horovod_tpu_torch/ops/csrc, every instantiation (fp32, bf16
               and fp16 at head widths 32, 64, 128, 192 and 256, and the
               wide one of each, any width above), both sources at once;
3. resources - registers, spills, shared memory and blocks per SM of every
               kernel instantiation as the card reports them; the bf16 and
               fp16 TMA/wgmma kernels, wide ones included, must not spill;
4. kernels   - each CUDA kernel against its plain PyTorch version on the
               same card tensors: the GPT-2-small shape (bf16 causal and
               not, fp16 causal), the BERT-Large shape (bf16, non-causal),
               the widths the kernels run at a wider instantiation (bf16
               at d 16, 48, 80, 96, causal and full, with a dlse), d 192
               and 256 (bf16 causal and full, fp32 and fp16 causal, a
               ragged 200 in bf16), v's width apart from q's (MLA's
               192/128 and 64/32, with offsets), a 16-bit width the TMA
               cannot read in place (the wrapper's zero-padded copy), the
               widths phase's bf16 shapes (B 8, T 1024, causal, 8 heads at
               d 96 and 3 at d 256), the gradients at the main path's
               16-bit shapes (fp16 at d 64, bf16 at d 96, 256, 384 and
               768) against float64 (no farther than the plain version's,
               normwise, and the noise in rows that see one key under the
               floor),
               the wide kernels (fp32, bf16 and fp16 at d 384 and at
               576/512, causal; bf16 at 288, 512, 768 and 1024, causal,
               512 full and with a ring's off-diagonal offsets, a padded
               copy at 300/290, a ragged 200 at 384, fp32 and bf16 at
               320/448 with Tq != Tk and offsets; the widths phase's 2
               and 1 heads of GPT-2 small; B 2, H 2, T 128-1024), batch *
               heads 65,600 (bf16 d 64, T 64), and small fp32/bf16
               shapes with offsets, a fully-future
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
               visible, against SDPA without a mask); then at the GPT-2
               small token count (B=8, T=1024, causal, H*d about 768) in
               fp16 at d 64, in bf16 at d 96 (8 heads) and 256 (3 heads),
               MLA's 192/128 (4 heads), and d 60 (the zero-padded copy)
               beside d 64 in bf16, and on the wide kernels: bf16 d 384 (2
               heads), 768 (1) and 288 (3: a 32-column remainder chunk),
               fp16 d 512 (2) and the absorbed MLA's 576/512 (4); each row
               names the SDPA backend that takes its shape (null where
               only the math backend does);
7. crossover - dense against flash attention, forward plus backward, over
               the key length (the routing threshold DEFAULT_FLASH_MIN_SEQ);
8. train     - the main path: init() on NCCL, GptSmall (bf16 compute, fp32
               params) at seq 1024 and batch 8, make_train_step with AdamW
               and bf16 gradient compression, 5 steps on one fixed batch;
               the loss must be finite and fall, and each kernel must have
               launched 12 times per step;
8a. widths   - the main path at the kernels' other dtypes and widths:
               GPT-2 small (12 layers, hidden 768, seq 1024, batch 8) as
               in train, in fp16 at 12 heads, in bf16 at 8 heads (d 96),
               3 heads (d 256), 2 heads (d 384) and 1 head (d 768, the
               last two on the wide kernels), 5 steps each on the flash
               kernels,
               then 5 steps from the same weights on the dense route
               (HOROVOD_FLASH_MIN_SEQ above 1024), fp16 with its loss
               scaled by 2^13: every loss finite, the flash run's within
               rel 1e-4 of the dense run's at step 1 and 5e-5 (fp16) or
               5e-4 (bf16) after, step 1's gradients of both routes
               against fp32 (the flash route's error at most 5 and 1.5
               times the dense route's, largest and median over leaves,
               where ds rounded to 16 bits puts the query and key leaves
               about twice as far; fp16's also unscaled, with the share
               of ds below fp16's smallest normal), 12 launches of each
               kernel a step and none on the dense route; step ms and MFU
               of each flash run;
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
10a. torch_api - the PyTorch frontend (``horovod_tpu_torch.torch``, the
               counterpart of horovod_tpu/torch) at world 1 on NCCL: every
               op on card tensors in fp32, fp16, bf16 and int32, the
               in-place forms, compression and the async forms with poll
               included, each equal to its world-1 value, and the four
               autograd mirrors equal to their closed form; GptSmall at
               seq 1024 and batch 8 trained as an upstream Horovod user
               writes it (broadcast_parameters, DistributedOptimizer(AdamW,
               named_parameters, fp16 wire, two backward passes per step)
               with an LR scheduler on it, broadcast_optimizer_state, 10
               microsteps): the loss must fall, the wrapper be an AdamW,
               each kernel launch 12 times per microstep and the
               parameters stay put off the boundary, with the eager rounds
               of each microstep and the reductions the hooks had submitted
               and launched when the backward returned; on one batch, one
               hook-driven step equal to one make_train_step step within
               rtol 1e-6, its reduced gradients bit-equal to a run whose
               hooks synchronize the card, a sharded=True step equal to it
               and an Adasum step equal to AdamW's local step; then
               SyncBatchNorm at ResNet-50's first BatchNorm (fp32, batch 32,
               64 channels, 112 x 112) against BatchNorm2d. The microstep
               ms are printed beside phase frontend's;
10b. obs     - the flight recorder at its default size (2048) on GPT-2
               small (seq 1024, batch 8, bf16): bench_record's ns per
               record on and off; the make_train_step step's ms with the
               recorder at 2048 and at 0, in interleaved turns (medians and
               spreads); DistributedOptimizer microsteps (as frontend's,
               each under metrics.timed_step), then flight_dump(): the
               port's attribute() must give compute + exposed + stall +
               host == step on every step, in whole microseconds, and
               check_flight_dumps() nothing; each microstep's window at
               least its card time (events around its work);
10c. tune    - GPT-2 small (bf16 compute, seq 1024, batch 8, weights and
               batch from seed 0) under TuningSession(default_space(
               engine_knobs=False)): bucket bytes and compression
               none/bf16/int8 with the accuracy guard, 4 steps an epoch,
               one warmup epoch, 6 samples, the step rebuilt from
               step_kwargs whenever on_step returns a config. It must
               converge within the budget, log a CSV row per sample,
               publish tune_config/<job> to an in-process KVServer, show
               rank 0 converged in ``obs.top --once --tune``, keep every
               loss finite and launch each kernel 12 times a step, and a
               step rebuilt fresh from the converged kwargs and the same
               state must give the same loss and parameters bit for bit;
               each step's window (closed on the card) at least the card
               time of its call. Each epoch's config, objective and
               source are printed. Then the eager plane's knobs on the
               DistributedOptimizer loop of phase obs (each microstep's
               loss through metric_average): a push (fusion 2 MiB, cycle
               0.5 ms, lane 2048 B) adopted at one round, parameters
               bit-equal to a run without it, the response cache's hit
               rate after the first microstep; HOROVOD_TIMELINE merged
               with the torch profiler's trace by profiler/trace_merge
               (every broadcast_parameters op and metric_average has its
               exec); HOROVOD_AUTOTUNE with small sample counts (its CSV,
               exact parameters, knobs within bounds). Last, the express
               lane's small_tensor_cliff_report: means, p50s, speedups,
               the lane's results bit-equal to the fused ones;
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
               be), against the dense per-token MoE;
14. elastic  - GPT-2 small (bf16 compute, fp32 params, seq 1024, batch 8,
               a new batch from a seed each step) for 8 steps under
               elastic.run, a commit every 2 steps, against run A (the
               same steps without elastic.run; its ZeRO-1 counterpart for
               run D): B, State with AdamW, the default NCCL group
               aborted after step 5, so step 6's collective must raise
               HorovodInternalError and run restores the step-4 commit,
               re-initializes NCCL, rebuilds the step and redoes steps 5-8;
               C, a hosts-updated notice before the step-4 commit (reset,
               no rollback); D, ShardedState over ZeRO-1 AdamW with B's
               fault, resuming from the live step; E, GPT-2 small
               through the PyTorch frontend's hook-driven
               DistributedOptimizer under elastic.run with
               TorchState(model, optimizer, ElasticSampler over 64 seeded
               sequences), one epoch, B's fault (the default NCCL group
               and the eager plane's data group aborted after step 5):
               every sample of the epoch must be trained on exactly once;
               F, D's job with the fault injected instead: run D counts
               the data sends before step 6 (HOROVOD_FAULT_SPEC
               data.send:delay_ms=0) and names step 1's, and run F runs
               under data.send:drop@frame=N, N step 6's reduce-scatter:
               that step must raise HorovodInternalError, and the job
               recover from the live step. (B, D and E abort the groups
               from outside the step; F places its fault inside it.)
               Each must end bit-equal to its run A, with its recovery
               split into detection, teardown, re-init and sync, commit ms
               and peak memory;
15. faults   - the fault-tolerance surface at world 1 on NCCL: the
               reference's fault specs accepted and its malformed ones
               refused naming HOROVOD_FAULT_SPEC (set_fault_spec, and
               init() with the variable set); GPT-2 small's replicated
               step timed without and with data.send:delay_ms=200 (the
               held step longer by the held sends' time, less at most one
               step); an eager allreduce held pending at control.send and
               failed by abort("chip smoke abort") with the reason, the
               executor unhealthy after; aborts counted once and
               faults_injected for every firing;
16. serve    - the serving plane at world 1 on NCCL, GEMMs in full fp32
               (TF32 off, checked): the tensor-parallel LM at GPT-2 small's
               widths (vocab 50257, hidden 768, mlp 3072, 12 layers, seed
               0; 95.2M fp32 parameters) through make_tp_lm_step. (a) its
               last-position logits on 8 ragged prompts (1-200 tokens,
               bucket 256) against the same model on the CPU (rtol 1e-4 /
               atol 1e-4, greedy tokens equal), and on the int8 activation
               wire against fp32 within the codec's bound (layers x 2
               max|logits| / 127), with the share of rows whose tokens
               agree; (b) the median ms of 20 step calls at buckets 32,
               256, 1024 and 2048 on each wire, decode tokens/s at batch
               8, peak memory; (c) 32 requests from 4 client threads over
               HTTP to ServeFrontend -> ContinuousBatcher(8) ->
               ServingLoop on the int8 LM (prompts of 8-200 tokens, 16 new
               tokens, deadline 30 s): each ok and equal to its prompt
               decoded alone, p50/p99, decode steps/s, tokens/s, mean
               occupancy, the decode thread's idle share; then a drain
               with 8 requests in flight (/healthz 503, none lost); (d)
               the fast path: the recurrent LM (hidden 192, vocab 256) on
               the card behind PagedKVCache(16, 256) with speculative
               decode (k 4) over the shared-prefix trace (prefix 160, tail
               16, 16 new tokens): tokens equal recompute's on 16 prompts,
               accept rate, ms per advance at batch 8, goodput of both
               stacks at one offered load, the pool balanced. It runs no
               flash kernel;
17. launch   - the launcher and the elastic driver
               (``python -m horovod_tpu_torch.runner.launch``) driving
               the port's scripts on the card as child processes: static,
               ``-np 1``, GPT-2 small through examples/gpt_train.py for 5
               steps, whose losses must equal the train phase's (the same
               model, batch, optimizer and wire from seed 0) and each kernel
               launch 12 times a step; elastic, min = max = 1, GPT-2 small
               under elastic.run (examples/elastic_train.py, 8 steps, a
               commit every 2) SIGKILLing itself once after the commit of
               step 4: the driver must record one worker_exit with reason
               failure (exit -9), no blacklist, and respawn the slot at
               generation 1 on the same card, which trains the job to its
               end (its first 4 losses equal to the first attempt's), with
               the detection and respawn seconds; serve, the driver in its
               durable mode spawning one serve worker (the TP LM at GPT-2
               small's widths, int8 wire), a RequestRouter reading the
               driver's serve_targets sending it 8 requests at once, each
               equal to its prompt decoded alone, then serve_stop. The
               kernels' launch counts come from the launched scripts. The
               elastic leg runs with HOROVOD_FLIGHT_DIR and HOROVOD_KV_DIR
               beside its journal: the port's hvd-doctor over that
               directory must give one incident, the SIGKILLed worker, and
               the flight analyzer's CLI must read the job's end dump; the
               serve worker exports its metrics, and
               ``python -m horovod_tpu_torch.obs.top --once --serving``
               must list its row while it serves. Then run,
               ``horovod_tpu_torch.run(run_leg_train, np=1)`` (this
               script's function, sent by reference): GPT-2 small for 5
               steps on cuda:0, the train phase's losses within rel 1e-5,
               12 launches a kernel a step, the seconds from the call to
               its return; replicated, GPT-2 small (the train phase's
               batch and wire) under elastic.run for 250 steps through
               the supervised launcher at min = max = 1 with
               HOROVOD_KV_REPLICAS=3: after step 2's commit an
               acknowledged key is written through the failover client
               and the KV leaseholder is SIGKILLed; a follower must win
               at a higher epoch, the supervisor respawn the replica
               (``kv_replica_respawn``), the key read back from the new
               leader, the three store hashes agree once healed, the job
               exit 0 with its first 5 losses the train phase's (rel
               1e-5) and 12 launches a kernel a step, with the seconds
               from the kill to the new leader and the largest step gap
               across the kill; examples, each user example once on the
               card (synthetic_benchmark at ResNet50 batch 128 with its
               images/s and long_context_attention on the flash kernels
               at T 32,768 with its 2 forward launches alone; mnist,
               serve, merged_trace and, through the launcher at -np 1,
               pytorch_mnist side by side), each exiting 0 after its own
               checks.
18. check    - the port's static and protocol checks, last:
               ``python -m horovod_tpu_torch.lint`` over this checkout
               (no finding), ``python -m horovod_tpu_torch.verify`` (the
               nine specs clean and exhaustive at the CI bound; all 24
               mutants caught, one through the CLI with its numbered
               trace), then ``--conformance`` over the directories the
               launch legs wrote: the elastic job's KV WAL and journal
               with its respawn's flight dump, the serve fleet's KV, and
               the replicated leg's three replica WALs and journal. Every
               replayed set must hold records and show no divergence.

The train, frontend, torch_api, bert and resnet lines carry the port's MFU
(profiler/mfu.py ``mfu_report``: FLOPs per token or image from
FlopCounterMode plus the flash kernels' share, over the card's bf16 peak),
which must lie in (0, 1]. Then the kernels line (launches per path: gpt,
widths, frontend, torch_api, obs, tune, bert, resnet, parallel, elastic,
faults, serve, launch, run, replicated, examples), the
nvidia-smi
line, and
the final ``{"ok": true, "device": ...}`` line. ``--out DIR`` also writes
the nvcc logs there, and phase tune's CSV logs, timeline and merged
trace (without it they go to a temporary directory); ``--profile`` adds one profiled GPT train step, one profiled
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
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

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


# with --out, every emitted line is kept there too (the standard output
# a run returns may be cut to its end)
_LINES = None


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _LINES is not None:
        with open(_LINES, "a") as f:
            f.write(line + "\n")


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
    smaller than the first rows, to their own resolution. fp16 (2^-11
    relative) is held to the same bounds. The gradients' floor: where a
    row's gradient cancels to about zero (a query that sees one key: ds =
    p (dp - delta) scale), what is left is the noise of dp's fp32 sum,
    which differs between wgmma's order and the plain version's and from a
    float64 reference by up to 2.5e-6 in the kernel and 1.9e-6 in the
    plain version (``float64_noise`` at the main path's 16-bit shapes on an
    H100; PERF.md §6): the floor is 4e-6."""
    import torch
    if dtype == torch.float32:
        return dict(fwd=(2e-4, 2e-5, 0.0, None), grad=(2e-3, 2e-4, 0.0, None),
                    lse=(1e-4, 1e-5, 0.0, None))
    return dict(fwd=(2e-2, 1e-6, 2e-2, 1e-2), grad=(2e-2, 4e-6, 2e-2, 1e-2),
                lse=(1e-4, 2e-3, 0.0, None))


NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the main path's 16-bit shapes held against float64 (``float64_noise``)
FLOAT64_CASES = ("main_f16_causal", "widths_bf16_h8_d96_causal",
                 "widths_bf16_h3_d256_causal", "widths_bf16_h2_d384_causal",
                 "widths_bf16_h1_d768_causal")
# the kernel cases at the shapes the main paths give the kernels (GPT-2
# small causal, BERT-Large non-causal, the world-1 ring's one call): the
# kernels line's max_abs_err
MAIN_PATH_CASES = ("main_bf16_causal", "bertlarge_bf16_full",
                   "par_bf16_t32768_causal", "main_f16_causal",
                   "widths_bf16_h8_d96_causal", "widths_bf16_h3_d256_causal",
                   "widths_bf16_h2_d384_causal", "widths_bf16_h1_d768_causal")


def width_key(w) -> str:
    """An instantiation's name in the lines: d<width>, or wide."""
    from horovod_tpu_torch.ops import flash_attention as fa
    return "wide" if w == fa._KERNEL_WIDE else f"d{w}"


def kernel_resources():
    """Registers, spill bytes, shared memory and resident blocks per SM of
    every kernel instantiation (each dtype at each head width, and the
    wide one), as the card reports them. The bf16 and fp16 TMA/wgmma
    kernels (forward, dq and dk/dv) must not spill: their accumulators are
    meant to live in registers."""
    from horovod_tpu_torch.ops import flash_attention as fa
    out = {}
    for name in NAMES:
        for dt in fa._KERNEL_DTYPES:
            for d in fa._KERNEL_HEAD_DIMS + (fa._KERNEL_WIDE,):
                info = fa.kernel_info(name, dt, d)
                key = f"{name}/{str(dt)[6:]}/{width_key(d)}"
                out[key] = info
                if dt.itemsize == 2 and info["local_bytes"]:
                    raise AssertionError(f"{key} spills: {info}")
    return out


def kernel_inputs(case, device):
    """q, k, v, do (v and do ``dv`` wide, d by default) and dlse of a
    case, from its seed."""
    import torch
    g = torch.Generator().manual_seed(case.get("seed", 0))
    dt = case["dtype"]
    b, tq, tk, h, d = case["b"], case["tq"], case["tk"], case["h"], case["d"]
    dv = case.get("dv", d)
    q = torch.randn(b, tq, h, d, generator=g).to(device, dt)
    k = torch.randn(b, tk, h, d, generator=g).to(device, dt)
    v = torch.randn(b, tk, h, dv, generator=g).to(device, dt)
    do = torch.randn(b, tq, h, dv, generator=g).to(device, dt)
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
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    m = dict(b=MAIN["b"], tq=MAIN["t"], tk=MAIN["t"], h=MAIN["h"],
             d=MAIN["d"], bq=512, bk=512, dtype=bf16)
    small = dict(b=2, tq=256, tk=256, h=4, bq=128, bk=128)
    bert = dict(b=BERT_SHAPE["b"], tq=BERT_SHAPE["t"], tk=BERT_SHAPE["t"],
                h=BERT_SHAPE["h"], d=BERT_SHAPE["d"], bq=512, bk=512,
                dtype=bf16)
    par = dict(b=PAR["b"], tq=PAR["t"], tk=PAR["t"], h=PAR["h"], d=PAR["d"],
               bq=512, bk=512, causal=True, dtype=bf16)
    shard = dict(par, tq=RING_SHARD["t"], tk=RING_SHARD["t"], dlse=True)
    wide = dict(b=2, tq=512, tk=512, h=2, bq=512, bk=512)
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
        # the kernels' whole envelope: fp16 at the main path's shape; the
        # widths that run at a wider instantiation (16 -> 32, 48 -> 64,
        # 80 and 96 -> 128) and the two widest, causal and full, with a
        # dlse; d 256 in fp32 and fp16; v's width apart from q's (MLA's
        # 192/128, and 64/32) with offsets; a ragged 200 at d 256; and a
        # 16-bit width whose rows the TMA cannot address (36 and 28: the
        # wrapper's zero-padded copy)
        dict(name="main_f16_causal", causal=True, seed=23,
             **dict(m, dtype=f16)),
        *[dict(name=f"bf16_d{d}_{'causal' if c else 'full'}", d=d, causal=c,
               dtype=bf16, dlse=True, seed=24 + d + c, **small)
          for d in (16, 48, 80, 96, 192, 256) for c in (True, False)],
        dict(name="f32_d256_causal", d=256, causal=True, dtype=f32,
             dlse=True, seed=25, **small),
        dict(name="f32_d192_full", d=192, causal=False, dtype=f32,
             dlse=True, seed=31, **small),
        dict(name="f16_d256_causal", d=256, causal=True, dtype=f16,
             dlse=True, seed=26, **small),
        dict(name="bf16_mla_d192_dv128_offsets", b=2, tq=128, tk=256, h=2,
             d=192, dv=128, bq=128, bk=128, causal=True, q_off=128.0,
             dtype=bf16, dlse=True, seed=27),
        dict(name="bf16_d64_dv32_offsets", b=2, tq=128, tk=256, h=2, d=64,
             dv=32, bq=128, bk=128, causal=True, q_off=128.0, dtype=bf16,
             dlse=True, seed=28),
        dict(name="bf16_d256_ragged_200", b=2, tq=200, tk=200, h=2, d=256,
             bq=200, bk=200, causal=True, dtype=bf16, dlse=True, seed=29),
        dict(name="bf16_d36_dv28_padded_copy", d=36, dv=28, causal=True,
             dtype=bf16, dlse=True, seed=30, **small),
        # the widths phase's bf16 shapes (GPT-2 small at 8 and 3 heads): d
        # 96 at instantiation 128, and d 256, where dk/dv splits over the
        # grid's z and the dS.K and dS^T.Q products run in 64-column panels
        dict(name="widths_bf16_h8_d96_causal", causal=True, seed=32,
             **dict(m, h=8, d=96)),
        dict(name="widths_bf16_h3_d256_causal", causal=True, seed=33,
             **dict(m, h=3, d=256)),
        # the wide kernels (any d and dv past 256, the head dimension cut
        # into 256-column chunks): each dtype at 384 and at the absorbed
        # MLA's 576/512; a 32-column remainder chunk (288), 512, 768 and
        # 1024 in bf16; 512 without a mask and at a ring's off-diagonal
        # offsets (every pair visible, a dlse); 16-bit rows the TMA cannot
        # address (300/290: the padded copy); a ragged 200; Tq != Tk with
        # offsets and dv apart from d (320/448); the widths phase's GPT-2
        # small at 2 and 1 heads
        *[dict(name=f"{n}_wide_d{d}_dv{dv}_causal", d=d, dv=dv,
               causal=True, dtype=dt, dlse=True, seed=34 + i, **wide)
          for i, (n, dt, d, dv) in enumerate(
              (n, dt, d, dv) for n, dt in (("f32", f32), ("bf16", bf16),
                                           ("f16", f16))
              for d, dv in ((384, 384), (576, 512)))],
        *[dict(name=f"bf16_wide_d{d}_causal", d=d, causal=True, dtype=bf16,
               dlse=True, seed=40 + i, **dict(wide, tq=t, tk=t, bq=t, bk=t))
          for i, (d, t) in enumerate(((288, 512), (512, 512), (768, 1024),
                                      (1024, 1024)))],
        dict(name="bf16_wide_d512_full", d=512, causal=False, dtype=bf16,
             dlse=True, seed=44, **wide),
        dict(name="bf16_wide_d512_ring_offdiag", d=512, causal=True,
             q_off=1024.0, k_off=0.0, dtype=bf16, dlse=True, seed=45, **wide),
        dict(name="bf16_wide_d300_dv290_padded_copy", d=300, dv=290,
             causal=True, dtype=bf16, dlse=True, seed=46, **wide),
        dict(name="bf16_wide_d384_ragged_200", b=2, tq=200, tk=200, h=2,
             d=384, bq=200, bk=200, causal=True, dtype=bf16, dlse=True,
             seed=50),
        dict(name="f32_wide_d320_dv448_offsets_tq_ne_tk", b=2, tq=128,
             tk=256, h=2, d=320, dv=448, bq=128, bk=128, causal=True,
             q_off=128.0, dtype=f32, dlse=True, seed=51),
        dict(name="bf16_wide_d320_dv448_offsets_tq_ne_tk", b=2, tq=128,
             tk=256, h=2, d=320, dv=448, bq=128, bk=128, causal=True,
             q_off=128.0, dtype=bf16, dlse=True, seed=52),
        dict(name="widths_bf16_h2_d384_causal", causal=True, seed=47,
             **dict(m, h=2, d=384)),
        dict(name="widths_bf16_h1_d768_causal", causal=True, seed=48,
             **dict(m, h=1, d=768)),
        # batch * heads past 65,535 (a grid's y limit): B*H on the grid's x
        dict(name="bf16_d64_bh65600", b=4, tq=64, tk=64, h=16400, d=64,
             bq=64, bk=64, causal=True, dtype=bf16, seed=49),
    ]


def float64_noise(device, name):
    """The gradients of case ``name`` (causal, no dlse) against float64 (ds
    unrounded): the kernel's and the plain version's largest and normwise
    error over all rows, and the largest over the rows that see one key (t
    = 0, where dq = ds k cancels to about zero and what is left is the
    noise of dp's sum). The kernel must stay inside the 16-bit gradients'
    floor there (4e-6, ``tolerances``), and within 1.1 times the plain
    version's normwise error everywhere."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    case = next(c for c in kernel_cases() if c["name"] == name)
    q, k, v, do, dlse = kernel_inputs(case, device)
    args = (case["causal"], case["d"] ** -0.5, 0.0, 0.0, case["bq"],
            case["bk"])
    o, lse = fa.flash_fwd_plain(q, k, v, *args)
    corr = (dlse - (do.float() * o.float()).sum(-1).transpose(1, 2)) \
        .contiguous()
    got = {"dq": fa.flash_bwd_dq(q, k, v, do, lse, corr, *args)}
    got["dk"], got["dv"] = fa.flash_bwd_dkv(q, k, v, do, lse, corr, *args)
    plain = {"dq": fa.flash_bwd_dq_plain(q, k, v, do, lse, corr, *args)}
    plain["dk"], plain["dv"] = fa.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                      corr, *args)
    qd, kd, vd, dod = (x.double() for x in (q, k, v, do))
    t = q.shape[1]
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qd, kd) * args[1] -
                  lse.double()[..., None])
    p = p * torch.ones(t, t, dtype=torch.bool, device=device).tril()
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dod, vd) +
              corr.double()[..., None]) * args[1]
    exact = {"dq": torch.einsum("bhqk,bkhd->bqhd", ds, kd),
             "dk": torch.einsum("bhqk,bqhd->bkhd", ds, qd),
             "dv": torch.einsum("bhqk,bqhd->bkhd", p, dod)}
    del p, ds
    out = {}
    for key, e in exact.items():
        kern, pl = got[key].double() - e, plain[key].double() - e
        out[key] = {"kernel_max_err": float(kern.abs().max()),
                    "plain_max_err": float(pl.abs().max()),
                    "kernel_norm_err": torch_norm(kern) / torch_norm(e),
                    "plain_norm_err": torch_norm(pl) / torch_norm(e)}
        if not out[key]["kernel_norm_err"] <= \
                1.1 * out[key]["plain_norm_err"]:
            raise AssertionError(f"{name}: {key} is farther from float64 "
                                 f"than the plain version: {out[key]}")
    # the rows that see one key: q row 0 of every batch and head
    out["dq"].update(one_key_kernel_max_err=float(
        (got["dq"][:, 0].double() - exact["dq"][:, 0]).abs().max()),
        one_key_plain_max_err=float(
            (plain["dq"][:, 0].double() - exact["dq"][:, 0]).abs().max()))
    floor = tolerances(case["dtype"])["grad"][1]
    if not out["dq"]["one_key_kernel_max_err"] <= floor:
        raise AssertionError(f"{name}: dq in rows that see one key is "
                             f"{out['dq']} from float64, floor {floor}")
    return out


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


def bounds(b, t, h, d, causal, dtype_name, q_off=0.0, k_off=0.0, dv=None):
    """Least time (ms) per kernel: each input read once and each output
    written once at the memory rate, against the products this run's data
    needs (only the causally visible q-k pairs, at these offsets; each
    product at its own width, q.k^T and dS-by-q/k ones at d, those with v
    or do at dv) at the tensor-core rate. The exp and elementwise work is
    not counted."""
    from horovod_tpu_torch.profiler.flops import attention_pairs
    dv = d if dv is None else dv
    esize = 4 if dtype_name == "float32" else 2
    pairs = b * h * attention_pairs(t, t, causal, q_off, k_off)
    x = b * t * h * d * esize          # one [B, T, H, d] tensor
    xv = b * t * h * dv * esize        # one [B, T, H, dv] tensor
    row = b * h * t * 4                # one [B, H, T] fp32 tensor
    work = {  # name -> (bytes, flops)
        # q, k, v in; o, lse out: q.k^T and p.v
        "flash_fwd": (2 * x + xv + xv + row, 2 * pairs * (d + dv)),
        # q, k, v, do, lse, corr in; dq out: q.k^T, do.v^T, ds.k
        "flash_bwd_dq": (2 * x + 2 * xv + 2 * row + x,
                         2 * pairs * (2 * d + dv)),
        # q, k, v, do, lse, corr in; dk, dv out: q.k^T, do.v^T, ds^T.q,
        # p^T.do
        "flash_bwd_dkv": (2 * x + 2 * xv + 2 * row + x + xv,
                          2 * pairs * (2 * d + 2 * dv)),
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


def timing(device, shape=MAIN, causal=True, q_off=0.0, k_off=0.0,
           dtype_name="bfloat16"):
    """Each kernel, its plain version and the SDPA yardstick at ``shape``
    (v and do ``shape["dv"]`` wide when given, else d), with q and k at
    global positions ``q_off`` and ``k_off``: a ring shard's diagonal
    block (equal offsets, the same function as offset 0, which SDPA
    computes causally) or a block whose every pair is visible (SDPA
    without a mask). Kernel and plain version alternate turn by turn; each
    time is the median of TURNS turns (a kernel turn is 50 launches)."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.profiler.flops import attention_pairs
    t = shape["t"]
    d, dv = shape["d"], shape.get("dv", shape["d"])
    every_pair = attention_pairs(t, t, causal, q_off, k_off) == t * t
    if causal and q_off != k_off and not every_pair:
        raise ValueError("SDPA has no mask for a block at these offsets")
    sdpa_causal = causal and not every_pair
    case = dict(name="timing", causal=causal, b=shape["b"], tq=shape["t"],
                tk=shape["t"], h=shape["h"], d=d, dv=dv, bq=512, bk=512,
                dtype=getattr(torch, dtype_name))
    q, k, v, do, dlse = kernel_inputs(case, device)
    args = (causal, d ** -0.5, q_off, k_off, 512, 512)
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
    # its backward alone is autograd.grad on a retained graph. The backend
    # SDPA picks for the shape is named; where only its math backend takes
    # it (which writes the whole score matrix), there is no yardstick.
    from torch.nn.attention import SDPBackend
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    backend = SDPBackend(torch._fused_sdp_choice(qh, kh, vh,
                                                 is_causal=sdpa_causal)).name
    fwd_t, bwd_t = [], []
    if backend != "MATH":
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qh, kh, vh))
        out = F.scaled_dot_product_attention(qg, kg, vg,
                                             is_causal=sdpa_causal)
        for _ in range(TURNS):
            fwd_t.append(time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=sdpa_causal), 50))
            bwd_t.append(time_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), doh, retain_graph=True), 50))
        del out
    sdpa_fwd = statistics.median(fwd_t) if fwd_t else None
    sdpa_bwd = statistics.median(bwd_t) if bwd_t else None
    # no single library call computes dq or dk/dv alone: SDPA's whole
    # backward is the joint yardstick of the two backward kernels together
    res["flash_fwd"].update(library_ms=sdpa_fwd, library_ms_joint=None)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        res[name].update(library_ms=None, library_ms_joint=sdpa_bwd)
    bnd = bounds(shape["b"], shape["t"], shape["h"], d, causal, dtype_name,
                 q_off, k_off, dv)
    for name, (ms, by, nbytes, flops) in bnd.items():
        res[name].update(bound_ms=ms, bound_by=by, bytes=nbytes,
                         flops=flops, share_of_bound=ms / res[name]["ms"])
    return res, {"sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd,
                 "sdpa_fwd_ms_turns": fwd_t, "sdpa_bwd_ms_turns": bwd_t,
                 "sdpa_backend": backend,
                 "sdpa_null_reason": None if fwd_t else
                 f"only SDPA's math backend takes d {d}, dv {dv}",
                 "busy_wait_cycles_per_ms": _SLEEP_CYCLES_PER_MS[0]}


# the kernels' other dtypes and widths at the GPT-2 small token count
# (B=8, T=1024, causal, H*d about 768 or more): name -> (shape, dtype). d 60
# runs through the wrapper's zero-padded copy (16-bit rows of 120 bytes,
# which the TMA cannot address); the d 64 row beside it reads in place.
# The rows from d 384 on run the wide kernels (d 288: two chunks, the
# second 32 columns; 576/512: the absorbed MLA's widths).
WIDTH_TIMINGS = {
    "f16_d64": (dict(b=8, t=1024, h=12, d=64), "float16"),
    "bf16_d96": (dict(b=8, t=1024, h=8, d=96), "bfloat16"),
    "bf16_d256": (dict(b=8, t=1024, h=3, d=256), "bfloat16"),
    "bf16_mla_d192_dv128": (dict(b=8, t=1024, h=4, d=192, dv=128),
                            "bfloat16"),
    "bf16_d60_padded_copy": (dict(b=8, t=1024, h=12, d=60), "bfloat16"),
    "bf16_d384": (dict(b=8, t=1024, h=2, d=384), "bfloat16"),
    "bf16_d768": (dict(b=8, t=1024, h=1, d=768), "bfloat16"),
    "bf16_d288": (dict(b=8, t=1024, h=3, d=288), "bfloat16"),
    "f16_d512": (dict(b=8, t=1024, h=2, d=512), "float16"),
    "bf16_mla_d576_dv512": (dict(b=8, t=1024, h=4, d=576, dv=512),
                            "bfloat16"),
}


def width_timings(device):
    """WIDTH_TIMINGS rows, each with every kernel's resources at the
    instantiation it runs at."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    lines = []
    for key, (shape, dtype_name) in WIDTH_TIMINGS.items():
        d, dv = shape["d"], shape.get("dv", shape["d"])
        w = fa.kernel_width(d, dv)
        dt = getattr(torch, dtype_name)
        times, sdpa = timing(device, shape, causal=True,
                             dtype_name=dtype_name)
        res = {name: fa.kernel_info(name, dt, w) for name in NAMES}
        lines.append({"phase": "timing", "row": key, "shape": shape,
                      "dtype": dtype_name, "causal": True,
                      "instantiated_width": width_key(w),
                      "reads_in_place": fa.reads_in_place(dt, d, dv),
                      "kernels": times, "resources": res, **sdpa})
        torch.cuda.empty_cache()
    return lines


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


# GPT-2 small at the kernels' other dtypes and widths: (compute dtype,
# heads, static loss scale); hidden 768 gives d 64, 96, 256, and on the
# wide kernels 384 and 768. fp16 runs
# as fp16 training does, with its loss scaled: unscaled, the backward's
# activation gradients (about 1e-6 to 1e-8 at 8,192 tokens) fall below
# fp16's smallest normal, 6.1e-5, where it keeps few bits (``widths_grads``)
WIDTH_RUNS = (("float16", 12, 2.0 ** 13), ("bfloat16", 8, 1.0),
              ("bfloat16", 3, 1.0), ("bfloat16", 2, 1.0),
              ("bfloat16", 1, 1.0))
# the flash run's loss against the dense route's, relative, at step 1 and
# at steps 2-5, by dtype: the two round p (and ds) to the 16-bit type at
# other places and sum in other orders, and AdamW steps carry the
# difference on. On an H100 (PERF.md §6) step 1 reads at most 1.8e-5 (bf16
# d 256) and steps 2-5 1.0e-4 (bf16) and 4.4e-6 (fp16, scaled): the limits
# are 5 to 10 times those
WIDTHS_LOSS_RTOL = {"float16": (1e-4, 5e-5), "bfloat16": (1e-4, 5e-4)}
# step 1's gradients on the flash route against fp32, over those on the
# dense route: (the largest, the median) over leaves may be at most these
# many times the dense route's. The flash route rounds ds to the 16-bit
# type before dS.K and dS^T.Q, as the reference's kernels do, where the
# dense route's autograd keeps ds in fp32, so its query and key leaves sit
# about twice as far from fp32; a wrong panel of dq, dk or dv would put its
# leaves' error near 1, tens of times the dense route's
WIDTHS_GRAD_RATIO = (5.0, 1.5)


def widths_model(device, dtype, heads):
    """The widths phase's GPT-2 small at ``heads`` heads computing in
    ``dtype``, its fp32 weights from seed 0, and its batch (seed 0)."""
    import torch
    from horovod_tpu_torch.models.gpt import GptDecoder
    model = GptDecoder(layers=12, hidden=768, heads=heads, mlp_dim=3072,
                       dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 50257, (MAIN["b"], MAIN["t"]),
                           generator=torch.Generator().manual_seed(0))
    return model.to(device), tokens


def widths_route(flash: bool):
    """The flash route from 1024 keys (the default crossover), or the
    dense route: a crossover above the sequence."""
    os.environ["HOROVOD_FLASH_MIN_SEQ"] = "1024" if flash else "2048"


def widths_run(device, dtype_name, heads, flash, loss_scale=1.0):
    """GPT-2 small (the train phase's model, batch, optimizer and wire from
    seed 0) at ``heads`` heads in ``dtype_name``, 5 steps on the flash
    kernels or on the dense route, the loss scaled by ``loss_scale`` and
    AdamW's eps with it (the same updates); (unscaled losses, step ms,
    launches, FLOPs estimate or None)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.gpt import lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import dp

    def scaled_loss(model, batch):
        loss, aux = lm_loss(model, batch)
        return loss * loss_scale, aux

    widths_route(flash)
    hvd.init()
    try:
        model, tokens = widths_model(hvd.device(), getattr(torch, dtype_name),
                                     heads)
        batch = dp.shard_batch(tokens).to(hvd.device())
        est = step_flops(lm_loss, model, batch) if flash else None
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                betas=(0.9, 0.999), eps=1e-8 * loss_scale,
                                weight_decay=1e-4)
        step = dp.make_train_step(model, scaled_loss, opt,
                                  compression=hvd.Compression.bf16)
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        losses, step_ms = [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            out = step(batch)
            losses.append(out.loss.item() / loss_scale)  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = fa.launch_counts()
    finally:
        hvd.shutdown()
        os.environ.pop("HOROVOD_FLASH_MIN_SEQ", None)
    return losses, step_ms, counts, est


def widths_grads(device, dtype_name, heads, loss_scale=1.0):
    """Step 1 of a widths run without the optimizer: the loss and the
    gradients of the same weights on the flash kernels and on the dense
    route in ``dtype_name`` (the loss scaled by ``loss_scale``, the
    gradients unscaled), each against the dense route in fp32. Per route:
    the loss's relative error, and over the leaves the largest and the
    median normwise error ||g - g32|| / ||g32|| and the share of entries
    zero where g32's are not. Of the flash route's first backward (the last
    layer): the share of do, and of the visible pairs' ds = p (dp + corr)
    scale, below the dtype's smallest normal and rounding to zero when cast
    to it, as the kernels cast ds for the dS.K and dS^T.Q products."""
    import torch
    from horovod_tpu_torch.models.gpt import lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    dt = getattr(torch, dtype_name)

    def grads(dtype, flash):
        model, tokens = widths_model(device, dtype, heads)
        widths_route(flash)
        try:
            loss, _ = lm_loss(model, tokens.to(device))
            (loss * loss_scale).backward()
        finally:
            os.environ.pop("HOROVOD_FLASH_MIN_SEQ", None)
        return float(loss.detach()), {n: p.grad / loss_scale
                                      for n, p in model.named_parameters()}

    loss32, g32 = grads(torch.float32, False)
    # leaves whose gradient is zero in exact arithmetic (the key bias, which
    # shifts a row's scores by one constant) hold only fp32's noise: no
    # relative error is taken of them
    norms = {n: torch_norm(g) for n, g in g32.items()}
    floor = 1e-4 * statistics.median(norms.values())
    null = sorted(n for n, x in norms.items() if x < floor)
    seen, backward = [], fa._Flash.backward

    def first_backward(ctx, do, dlse):  # keeps the first backward's inputs
        if not seen:
            seen.append((*ctx.saved_tensors, do, dlse, ctx.args[1]))
        return backward(ctx, do, dlse)

    fa._Flash.backward = staticmethod(first_backward)
    try:
        routes = {"flash": grads(dt, True)}
    finally:
        fa._Flash.backward = staticmethod(backward)
    routes["dense"] = grads(dt, False)
    out = {"loss_fp32": loss32, "null_leaves": null}
    for route, (loss, g) in routes.items():
        errs, zero, live = {}, 0, 0
        for n, ref in g32.items():
            if n not in null:
                errs[n] = torch_norm(g[n].double() - ref.double()) / norms[n]
            nz = ref != 0
            zero += int(((g[n] == 0) & nz).sum())
            live += int(nz.sum())
        worst = max(errs, key=errs.get)
        out[route] = {"loss": loss, "loss_rel_err": abs(loss - loss32) /
                      abs(loss32), "max_leaf_err": errs[worst],
                      "worst_leaf": worst,
                      "median_leaf_err": statistics.median(errs.values()),
                      "zero_share": zero / max(live, 1), "leaf_err": errs}
    del routes, g32
    q, k, v, o, lse, do, dlse, scale = (
        x.detach() if isinstance(x, torch.Tensor) else x for x in seen[0])
    do = do.to(dt)
    corr = dlse.float() - (do.float() * o.float()).sum(-1).transpose(1, 2)
    t = q.shape[1]
    vis = torch.ones(t, t, dtype=torch.bool, device=device).tril()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) *
                  scale - lse[..., None]) * vis
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float()) +
              corr[..., None]) * scale
    del p
    n_vis = float(vis.sum()) * q.shape[0] * q.shape[2]
    tiny = torch.finfo(dt).tiny
    out["last_layer"] = {
        "do_below_normal_share": float((do.abs() < tiny).float().mean()),
        "do_zero_share": float((do == 0).float().mean()),
        "ds_below_normal_share": float(((ds.abs() < tiny) & vis).sum()) /
        n_vis,
        "ds_zero_share": float(((ds.to(dt) == 0) & vis).sum()) / n_vis,
        "ds_abs_median": float(ds[:, :, vis].abs().median())}
    return out


def widths_phase(device, card):
    """The widths phase: each WIDTH_RUNS configuration's step-1 gradients on
    both routes against fp32 (``widths_grads``; fp16 also unscaled, which
    shows why it is scaled), then 5 steps on the flash kernels and 5 on the
    dense route from the same weights: the losses finite and within
    WIDTHS_LOSS_RTOL step by step, the gradients within WIDTHS_GRAD_RATIO,
    12 launches of each kernel a step on the flash route and none on the
    dense one. Returns (the flash runs' launches, the line)."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    t_phase = time.perf_counter()
    counts = {name: 0 for name in NAMES}
    runs = []
    tokens = MAIN["b"] * MAIN["t"]
    for dtype_name, heads, scale in WIDTH_RUNS:
        key = f"{dtype_name}_h{heads}_d{768 // heads}"
        grads = widths_grads(device, dtype_name, heads, scale)
        unscaled = widths_grads(device, dtype_name, heads) \
            if scale != 1.0 else None
        for stat, ratio in zip(("max_leaf_err", "median_leaf_err"),
                               WIDTHS_GRAD_RATIO):
            if not grads["flash"][stat] <= ratio * grads["dense"][stat]:
                raise AssertionError(
                    f"widths/{key}: step 1's gradients on the flash route "
                    f"{grads['flash']} against the dense route's "
                    f"{grads['dense']}")
        for g in (grads, unscaled or {}):
            for route in ("flash", "dense"):
                if route in g:
                    g[route].pop("leaf_err")
        losses, step_ms, launches, est = widths_run(device, dtype_name,
                                                    heads, True, scale)
        dense, dense_ms, dense_launches, _ = widths_run(
            device, dtype_name, heads, False, scale)
        torch.cuda.empty_cache()
        want = 12 * STEPS
        if launches != {k: want for k in launches}:
            raise AssertionError(f"widths/{key}: launches {launches}, want "
                                 f"{want} each")
        if any(dense_launches.values()):
            raise AssertionError(f"widths/{key}: the dense route launched "
                                 f"{dense_launches}")
        if not all(math.isfinite(x) for x in losses + dense):
            raise AssertionError(f"widths/{key}: non-finite loss {losses} "
                                 f"{dense}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, dense)]
        first, later = WIDTHS_LOSS_RTOL[dtype_name]
        if rel[0] > first or max(rel[1:]) > later:
            raise AssertionError(f"widths/{key}: flash losses {losses} "
                                 f"against dense {dense} (rel {rel}, limits "
                                 f"{first} at step 1, {later} after)")
        for name in NAMES:
            counts[name] += launches[name]
        steady = sum(step_ms[1:]) / len(step_ms[1:])
        runs.append({
            "run": key, "dtype": dtype_name, "heads": heads,
            "head_dim": 768 // heads, "loss_scale": scale,
            "instantiated_width": width_key(fa.kernel_width(768 // heads,
                                                            768 // heads)),
            "losses": losses, "dense_losses": dense, "rel_err": rel,
            "loss_rtol": [first, later], "step1_grads": grads,
            "step1_grads_unscaled": unscaled,
            "step_ms": step_ms, "steady_step_ms": steady,
            "dense_step_ms": dense_ms,
            "tokens_per_s": tokens / (steady / 1e3),
            "mfu": mfu_entry(est, tokens, tokens / (steady / 1e3)),
            "launches": launches})
    return counts, {"phase": "widths", "nvidia_smi": card,
                    "model": "GptDecoder(layers=12, hidden=768)",
                    "batch": MAIN["b"], "seq": MAIN["t"], "steps": STEPS,
                    "grad_ratio": WIDTHS_GRAD_RATIO, "runs": runs,
                    "launches": counts,
                    "seconds": time.perf_counter() - t_phase}


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
# the PyTorch frontend (horovod_tpu_torch.torch, the counterpart of
# horovod_tpu/torch): its ops on card tensors, GPT-2 small through the
# hook-driven DistributedOptimizer, SyncBatchNorm at ResNet-50's first
# BatchNorm

TORCH_API = dict(micro=10, bpps=2, lr=3e-4, weight_decay=1e-4,
                 bn=(32, 64, 112, 112))


def torch_api_ops_check(device):
    """Every op of horovod_tpu_torch.torch on card tensors at world 1, in
    fp32, fp16, bf16 and int32, each equal to its world-1 value (in-place
    forms writing it into their input); the four autograd mirrors'
    gradients equal to their closed form (each the cotangent at world 1),
    and their outputs to the input."""
    import torch
    import horovod_tpu_torch.torch as hvd
    checked = []
    g = torch.Generator().manual_seed(9)
    for dt in (torch.float32, torch.float16, torch.bfloat16, torch.int32):
        x = (torch.randn(8, 4, generator=g) * 4).to(device, dt)
        tag = str(dt)[6:]
        pairs = [(f"allreduce_{op.name}", hvd.allreduce(
            x, op=op, name=f"api.{op.name}.{tag}"), x)
            for op in (hvd.Sum, hvd.Average, hvd.Min, hvd.Max, hvd.Product)]
        pairs += [
            ("allreduce_scaled", hvd.allreduce(
                x, op=hvd.Sum, prescale_factor=2.0, postscale_factor=0.5),
             x),
            ("allreduce_legacy_average", hvd.allreduce(x, average=True), x),
            ("grouped_allreduce", hvd.grouped_allreduce([x, x[0]])[1], x[0]),
            ("allgather_ragged", hvd.allgather(x[:3]), x[:3]),
            ("alltoall_splits", hvd.alltoall(x, splits=[8]), x),
            ("alltoall_even", hvd.alltoall(x), x),
            ("broadcast", hvd.broadcast(x, 0), x)]
        for name, wire in (("fp16", hvd.Compression.fp16),
                           ("bf16", hvd.Compression.bf16)):
            got = hvd.allreduce(x, compression=wire)
            pairs.append((f"allreduce_compressed_{name}", got,
                          wire.decompress(*wire.compress(x))))
        if dt.is_floating_point:
            pairs.append(("allreduce_adasum", hvd.allreduce(
                x, op=hvd.Adasum), x))
        for name, run in (
                ("allreduce_", lambda y: hvd.allreduce_(y, op=hvd.Sum)),
                ("allreduce_async_", lambda y: hvd.synchronize(
                    hvd.allreduce_async_(y))),
                ("broadcast_", lambda y: hvd.broadcast_(y, 0)),
                ("broadcast_async_", lambda y: hvd.synchronize(
                    hvd.broadcast_async_(y, 0))),
                ("grouped_allreduce_", lambda y: hvd.grouped_allreduce_(
                    [y])[0]),
                ("grouped_allreduce_async_", lambda y: hvd.synchronize(
                    hvd.grouped_allreduce_async_([y])[0]))):
            y = x.clone()
            if run(y) is not y:
                raise AssertionError(f"torch_api: {name} {tag} did not "
                                     "return its input")
            pairs.append((name, y, x))
        h = hvd.allreduce_async(x, op=hvd.Sum)
        while not hvd.poll(h):
            pass
        pairs.append(("allreduce_async", hvd.synchronize(h), x))
        for name, got, want in pairs:
            if got.dtype != want.dtype or got.device != x.device or \
                    not bool(torch.equal(got, want)):
                raise AssertionError(f"torch_api: {name} {tag} differs "
                                     "from its world-1 value")
            checked.append(f"{name}/{tag}")
    for name, fn, rows in (
            ("allreduce", lambda t: hvd.allreduce(t, op=hvd.Sum), 8),
            ("allreduce_scaled", lambda t: hvd.allreduce(
                t, op=hvd.Average, prescale_factor=2.0,
                postscale_factor=0.5), 8),
            ("allgather", hvd.allgather, 3),
            ("broadcast", lambda t: hvd.broadcast(t, 0), 8),
            ("alltoall", lambda t: hvd.alltoall(t, splits=[len(t)]), 5)):
        x = torch.randn(rows, 4, generator=g).to(device).requires_grad_(True)
        cot = torch.randn(rows, 4, generator=g).to(device)
        y = fn(x)
        (y * cot).sum().backward()
        if not (torch.equal(y.detach(), x.detach()) and
                torch.equal(x.grad, cot)):
            raise AssertionError(f"torch_api: the {name} mirror's gradient "
                                 "is not its closed form")
        checked.append(f"grad_{name}")
    hvd.barrier()
    if hvd.join() != -1:
        raise AssertionError("torch_api: join() at world 1")
    checked += ["barrier", "join"]
    return checked


def torch_api_build(state, device, bpps=1, compression=None, **kw):
    """GPT-2 small from ``state`` on the card and the frontend's
    DistributedOptimizer over its AdamW, named after its parameters."""
    import torch
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.models.gpt import GptSmall
    with torch.device(device):
        model = GptSmall(dtype=torch.bfloat16)
    model.load_state_dict(state)
    inner = torch.optim.AdamW(model.parameters(), lr=TORCH_API["lr"],
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=TORCH_API["weight_decay"])
    return model, hvd.DistributedOptimizer(
        inner, named_parameters=model.named_parameters(),
        compression=compression or hvd.Compression.none,
        backward_passes_per_step=bpps, **kw)


def torch_api_gpt(device, state, batches):
    """GPT-2 small as an upstream Horovod user writes the loop:
    broadcast_parameters, DistributedOptimizer(AdamW, named_parameters,
    fp16 wire, two backward passes per step), broadcast_optimizer_state,
    an LR scheduler on the wrapper, TORCH_API["micro"] microsteps
    (backward every microstep, step and zero_grad every second). The loss
    must fall; every kernel launch 12 times per microstep; the parameters
    stay put off the boundary. Counted: the eager rounds of each
    microstep, and on each boundary the reductions the hooks submitted
    during the backward and those already launched when it returned,
    with the host's time split at the backward's and step()'s returns."""
    import torch
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import eager
    from horovod_tpu_torch.models.gpt import lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    model, opt = torch_api_build(state, device, TORCH_API["bpps"],
                                 hvd.Compression.fp16)
    if not isinstance(opt, torch.optim.AdamW):
        raise AssertionError(f"torch_api: {type(opt).__mro__} is no AdamW")
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.9)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    ex = eager.get_executor()
    n_params = len(list(model.parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, micro_ms, rounds, unchanged, overlap = [], [], [], 0, []
    for k in range(TORCH_API["micro"]):
        boundary = (k + 1) % TORCH_API["bpps"] == 0
        before = None if boundary else \
            [p.detach().clone() for p in model.parameters()]
        r0 = ex._round
        t0 = time.perf_counter()
        loss = lm_loss(model, batches[k % 2])[0]
        loss.backward()
        t1 = time.perf_counter()
        if boundary:
            overlap.append({
                "submitted": len(opt._handles),
                "launched": sum(h.op._launched.is_set()
                                for h, _ in opt._handles.values())})
            opt.step()
            sched.step()
            opt.zero_grad()
        t2 = time.perf_counter()
        losses.append(loss.item())  # waits for the microstep
        micro_ms.append((time.perf_counter() - t0) * 1e3)
        if boundary:
            # the host's time: forward and backward issued, step()
            # returned (synchronize's waits and the inner step issued),
            # then the wait for the card
            overlap[-1]["host_ms"] = {
                "forward_backward": (t1 - t0) * 1e3,
                "step": (t2 - t1) * 1e3,
                "wait": micro_ms[-1] - (t2 - t0) * 1e3}
        rounds.append(ex._round - r0)
        if before is not None:
            if not all(torch.equal(a, p) for a, p in
                       zip(before, model.parameters())):
                raise AssertionError(f"torch_api: microstep {k} off the "
                                     "boundary moved the parameters")
            unchanged += 1
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    lr = opt.param_groups[0]["lr"]
    # equal on every rank of a job (tests/test_torch_cuda_dist.py)
    checksum = sum(float(p.detach().double().sum())
                   for p in model.parameters())
    del model, opt, before
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"torch_api: non-finite loss {losses}")
    if not (losses[-2] < losses[0] and losses[-1] < losses[1]):
        raise AssertionError(f"torch_api: loss did not fall {losses}")
    want = 12 * TORCH_API["micro"]
    if counts != {k: want for k in counts}:
        raise AssertionError(f"torch_api: launches {counts}, want {want} "
                             "each")
    if any(o["submitted"] != n_params for o in overlap):
        raise AssertionError(f"torch_api: the hooks submitted {overlap} "
                             f"reductions of {n_params}")
    boundary_ms, accumulate_ms = micro_ms[3::2], micro_ms[2::2]
    return counts, {
        "model": "GptSmall", "batch": MAIN["b"], "seq": MAIN["t"],
        "optimizer": f"horovod_tpu_torch.torch.DistributedOptimizer(AdamW("
                     f"lr={TORCH_API['lr']}, weight_decay="
                     f"{TORCH_API['weight_decay']}), named_parameters, "
                     f"compression=fp16, backward_passes_per_step="
                     f"{TORCH_API['bpps']}) + StepLR(gamma=0.9)",
        "isinstance_adamw": True, "lr_after": lr,
        "microsteps": TORCH_API["micro"], "losses": losses,
        "microstep_ms": micro_ms,
        "accumulate_microstep_ms": statistics.mean(accumulate_ms),
        "boundary_microstep_ms": statistics.mean(boundary_ms),
        "eager_rounds_by_microstep": rounds,
        "reductions_per_boundary": n_params,
        "hook_overlap": overlap,
        "unchanged_off_boundary": unchanged, "launches": counts,
        "peak_mem_bytes": peak, "param_checksum": checksum}


def torch_api_equalities(device, state, batch):
    """On one batch, from the same weights: one hook-driven step (one
    backward pass per step, no compression) against one make_train_step
    step within rtol 1e-6; its reduced gradients bit-equal to those of a
    run that synchronizes the card inside each hook (a hook that read the
    gradient on the wrong stream would differ), read after a manual
    synchronize() and stepped under skip_synchronize(); one sharded=True
    step against it; and one Adasum step against the inner AdamW's local
    step (the delta added back: rtol 1e-6)."""
    import torch
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.models.gpt import GptSmall, lm_loss
    from horovod_tpu_torch.parallel import dp
    out = {}

    def hook_step(synced_hooks=False, **kw):
        model, opt = torch_api_build(state, device, **kw)
        if synced_hooks:
            plain = opt._allreduce_grad_async

            def synced(p):
                torch.cuda.synchronize()
                return plain(p)
            opt._allreduce_grad_async = synced
        opt.zero_grad()
        lm_loss(model, batch)[0].backward()
        grads = None
        if "op" not in kw:
            opt.synchronize()
            grads = [p.grad.clone() for p in model.parameters()]
            with opt.skip_synchronize():
                opt.step()
        else:
            opt.step()
        params = [p.detach().clone() for p in model.parameters()]
        del model, opt
        torch.cuda.empty_cache()
        return params, grads

    hooked, grads = hook_step()
    _, synced_grads = hook_step(synced_hooks=True)
    if not all(torch.equal(a, b) for a, b in zip(grads, synced_grads)):
        raise AssertionError("torch_api: reduced gradients differ when the "
                             "hooks synchronize the card")
    with torch.device(device):
        ref = GptSmall(dtype=torch.bfloat16)
    ref.load_state_dict(state)
    names = [n for n, _ in ref.named_parameters()]
    opt = torch.optim.AdamW(
        ref.parameters(), lr=TORCH_API["lr"], betas=(0.9, 0.999), eps=1e-8,
        weight_decay=TORCH_API["weight_decay"])
    dp.make_train_step(ref, lm_loss, opt)(batch).loss.item()
    out["vs_make_train_step_max_abs_err"] = max(
        close(f"torch_api: hook-driven step vs make_train_step {n}", a,
              b.detach(), 1e-6, 0.0)[0]
        for n, a, b in zip(names, hooked, ref.parameters()))
    del ref, opt
    torch.cuda.empty_cache()
    sharded, _ = hook_step(sharded=True)
    out["sharded_vs_unsharded_max_abs_err"] = max(
        close(f"torch_api: sharded step {n}", a, b, 1e-6, 0.0)[0]
        for n, a, b in zip(names, sharded, hooked))
    adasum, _ = hook_step(op=hvd.Adasum)
    with torch.device(device):
        local = GptSmall(dtype=torch.bfloat16)
    local.load_state_dict(state)
    opt = torch.optim.AdamW(
        local.parameters(), lr=TORCH_API["lr"], betas=(0.9, 0.999),
        eps=1e-8, weight_decay=TORCH_API["weight_decay"])
    lm_loss(local, batch)[0].backward()
    opt.step()
    out["adasum_vs_local_step_max_abs_err"] = max(
        close(f"torch_api: Adasum step vs the local step {n}", a,
              b.detach(), 1e-6, 1e-7)[0]
        for n, a, b in zip(names, adasum, local.parameters()))
    del local, opt
    torch.cuda.empty_cache()
    out["reduced_grads_equal_with_synced_hooks"] = True
    return out


def torch_api_sync_bn(device):
    """The frontend's SyncBatchNorm at ResNet-50's first BatchNorm (fp32,
    batch 32, 64 channels, 112 x 112) against nn.BatchNorm2d on the same
    tensors: at world 1 its forward is BatchNorm's (whether each of the
    output, the input, weight and bias gradients and the running
    statistics is bit-equal is reported), and both it and its synchronized
    path (what it runs at world > 1, one eager allreduce of the sums) must
    be within 1e-5 of the largest value of each, elementwise and
    normwise."""
    import torch
    import horovod_tpu_torch.torch as hvd
    g = torch.Generator().manual_seed(6)
    shape = TORCH_API["bn"]
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(device)
    cot = torch.randn(*shape, generator=g).to(device)
    outs = {}
    for kind in ("forward", "synced", "batchnorm"):
        bn = (torch.nn.BatchNorm2d(shape[1]) if kind == "batchnorm" else
              hvd.SyncBatchNorm(shape[1])).to(device)
        xg = x.clone().requires_grad_(True)
        y = bn._synced(xg) if kind == "synced" else bn(xg)
        (y * cot).sum().backward()
        outs[kind] = {"y": y.detach(), "dx": xg.grad,
                      "dweight": bn.weight.grad, "dbias": bn.bias.grad,
                      "running_mean": bn.running_mean.clone(),
                      "running_var": bn.running_var.clone()}
    torch.cuda.synchronize()
    errs, equal = {"forward": {}, "synced": {}}, {}
    for key, want in outs["batchnorm"].items():
        equal[key] = bool(torch.equal(outs["forward"][key], want))
        scale = float(want.abs().max())
        for kind in ("forward", "synced"):
            errs[kind][key] = close(
                f"torch_api: SyncBatchNorm {kind} {key}", outs[kind][key],
                want, 0.0, 1e-5 * scale, norm_tol=1e-5)[0] / scale
    return {"shape": list(shape), "forward_bit_equal": equal,
            "rel_err": errs}


def torch_api_phase(device, card, front_line, gpt_flops):
    """The torch_api phase at world 1 on NCCL: the ops, GPT-2 small
    through the hook-driven DistributedOptimizer, the step equalities and
    SyncBatchNorm, beside phase frontend's microstep ms."""
    import torch
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.models.gpt import GptSmall
    t0 = time.perf_counter()
    hvd.init()
    try:
        checked = torch_api_ops_check(device)
        base = GptSmall(dtype=torch.bfloat16)
        base.reset_parameters(torch.Generator().manual_seed(0))
        state = {k: v.to(device) for k, v in base.state_dict().items()}
        del base
        gen = torch.Generator().manual_seed(1)
        batches = [torch.randint(0, 50257, (MAIN["b"], MAIN["t"]),
                                 generator=gen).to(device) for _ in range(2)]
        counts, gpt = torch_api_gpt(device, state, batches)
        gpt.update(torch_api_equalities(device, state, batches[0]))
        bn = torch_api_sync_bn(device)
    finally:
        hvd.shutdown()
    step_s = ((TORCH_API["bpps"] - 1) * gpt["accumulate_microstep_ms"] +
              gpt["boundary_microstep_ms"]) / 1e3
    tokens = MAIN["b"] * MAIN["t"]
    gpt["tokens_per_s"] = TORCH_API["bpps"] * tokens / step_s
    gpt["mfu"] = mfu_entry(gpt_flops, tokens, gpt["tokens_per_s"])
    front = front_line["gpt"]
    return counts, {
        "phase": "torch_api", "nvidia_smi": card, "backend": "nccl",
        "world_size": 1, "ops_checked": len(checked), "ops_cases": checked,
        "gpt": gpt, "sync_batch_norm": bn,
        "frontend_microstep_ms": {
            "accumulate": front["accumulate_microstep_ms"],
            "boundary": front["boundary_microstep_ms"]},
        "seconds": time.perf_counter() - t0}


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


# the obs phase: interleaved turns of the train step with the recorder on
# and off, and the DistributedOptimizer microsteps it then attributes
OBS = dict(bench_iters=200_000, turns=6, steps=5, micro=10)


def obs_phase(device, card):
    """The flight recorder and the step attributor on GPT-2 small at full
    width: the recorder's cost per record and per train step (recorder at
    its default 2048 against 0, interleaved turns of OBS["steps"] steps
    after one warm-up step), then frontend's DistributedOptimizer
    microsteps under ``timed_step`` and their attribution from the dump."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import flight_recorder as fr
    from horovod_tpu_torch.metrics import timed_step
    from horovod_tpu_torch.models.gpt import GptSmall, lm_loss
    from horovod_tpu_torch.obs import attribution
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import dp
    from horovod_tpu_torch.verify import conformance
    t_phase = time.perf_counter()
    bench = {"ns_per_record_on": fr.bench_record(OBS["bench_iters"], True),
             "ns_per_record_off": fr.bench_record(OBS["bench_iters"],
                                                  False)}
    size = fr.capacity_from_env()
    if size != fr.DEFAULT_CAPACITY:
        raise AssertionError(f"obs: recorder size {size}, want the default")
    hvd.init()
    try:
        model = GptSmall(dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(0))
        layers = len(model.blocks)
        tokens = torch.randint(0, 50257, (MAIN["b"], MAIN["t"]),
                               generator=torch.Generator().manual_seed(0))
        batch = tokens.to(device)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        step = dp.make_train_step(model, lm_loss, opt,
                                  compression=hvd.Compression.bf16)
        fa.reset_launch_counts()
        step(batch).loss.item()  # warm-up, not timed
        step_ms = {"on": [], "off": []}
        for turn in range(OBS["turns"]):
            for key in (("on", "off") if turn % 2 == 0 else ("off", "on")):
                fr.reset_recorder(size if key == "on" else 0)
                for _ in range(OBS["steps"]):
                    t0 = time.perf_counter()
                    step(batch).loss.item()
                    step_ms[key].append((time.perf_counter() - t0) * 1e3)
        del model, opt, step
        torch.cuda.empty_cache()
        # frontend's loop, each microstep under the shared step timer
        fr.reset_recorder(size)
        model = GptSmall(dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(device)
        gen = torch.Generator().manual_seed(1)
        batches = [torch.randint(0, 50257, (MAIN["b"], MAIN["t"]),
                                 generator=gen).to(device) for _ in range(2)]
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=FRONT["lr"],
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=FRONT["weight_decay"]),
            compression=hvd.Compression.bf16,
            backward_passes_per_step=FRONT["bpps"])
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)

        def microstep(b, span):
            # the events around the microstep's work, inside the step
            # timer: the card idles after loss.item(), so events outside
            # it would also time the timer's host work (every 10th step
            # the attributor's ring refresh takes the GIL for ms)
            with span:
                opt.zero_grad(set_to_none=True)
                loss = lm_loss(model, b)[0]
                loss.backward()
                opt.step()
                return loss.item()  # waits for the microstep

        timed = timed_step(microstep, "torch")
        attr = attribution.get_attributor()
        first_id = attr._steps + 1 if attr is not None else None
        losses, spans = [], []
        for k in range(OBS["micro"]):
            spans.append(CardSpan(device))
            losses.append(timed(batches[k % 2], spans[-1]))
        t0 = time.perf_counter()
        dump = hvd.flight_dump()
        dump_ms = (time.perf_counter() - t0) * 1e3
        counts = fa.launch_counts()
        del model, opt
        torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
        fr.reset_recorder()
    want = layers * (1 + 2 * OBS["turns"] * OBS["steps"] + OBS["micro"])
    if counts != {k: want for k in counts}:
        raise AssertionError(f"obs: launches {counts}, want {want} each")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"obs: non-finite loss {losses}")
    record = attribution.attribute({0: dump})
    steps = record["steps"]
    if len(steps) != OBS["micro"]:
        raise AssertionError(f"obs: {len(steps)} attributed steps, want "
                             f"{OBS['micro']}")
    parts = ("compute_s", "exposed_comm_s", "stall_s", "host_s")
    for s in steps:
        dec = s["ranks"][0]
        if sum(round(dec[k] * 1e6) for k in parts) != \
                round(dec["step_s"] * 1e6):
            raise AssertionError(f"obs: step {s['step']}: {dec} does not "
                                 "sum to its step")
    divergences = conformance.check_flight_dumps({0: dump})
    if divergences:
        raise AssertionError(f"obs: conformance {divergences}")
    windows = check_windows("obs", dump, first_id, spans)
    on, off = step_ms["on"], step_ms["off"]
    return counts, {
        "phase": "obs", "nvidia_smi": card, "model": "GptSmall",
        "batch": MAIN["b"], "seq": MAIN["t"], "recorder_size": size,
        **bench,
        "train_step_ms": {
            "turns": OBS["turns"], "steps_per_turn": OBS["steps"],
            "on_median": statistics.median(on),
            "off_median": statistics.median(off),
            "on_spread": [min(on), max(on)],
            "off_spread": [min(off), max(off)],
            "on": on, "off": off},
        "microsteps": OBS["micro"], "losses": losses,
        "events_in_dump": len(dump["events"]), "dump_ms": dump_ms,
        "attribution": [{"step": s["step"], **{
            k: s["ranks"][0][k] for k in ("step_s",) + parts +
            ("comm_busy_s", "overlapped_comm_s", "collectives",
             "gating_tensor")}} for s in steps],
        "summary": record["summary"], "identity_holds": True,
        "windows": windows,
        "conformance": divergences, "launches": counts,
        "seconds": time.perf_counter() - t_phase}


class CardSpan:
    """Timing events on the current stream around a block: ``us`` is the
    card's time between them once they have completed."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        import torch
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        import torch
        self.end.record(torch.cuda.current_stream(self.device))

    @property
    def us(self) -> float:
        self.end.synchronize()
        return self.start.elapsed_time(self.end) * 1e3


# Events around a step call that returns before the card is done (phase
# tune) also time the step timer's host work before STEP_BEGIN while the
# card idles (tens of us, more on a wrapper's first call): the window may
# fall short of them by that much, 1% of a step at most. A window that
# closes on the host instead falls short by the card's whole lag (21-33
# ms windows of the 219 ms four-card fp32 step).
WINDOW_SLACK = 0.01


def check_windows(phase, dump, first_id, spans) -> dict:
    """Item 0 of the step windows: the flight ring's window of each step
    ``first_id + k`` is at least the card time of that step (``spans[k]``,
    events around the call), and its attribution sums to it in whole
    microseconds. Returns the margins."""
    from horovod_tpu_torch.obs import attribution
    if first_id is None:
        raise AssertionError(f"{phase}: step attribution is off")
    wins = {w["step"]: w for w in attribution.step_windows(dump)}
    decs = {d["step"]: d for d in attribution.decompose_rank(dump)}
    parts = ("compute_s", "exposed_comm_s", "stall_s", "host_s")
    margins, rows = [], []
    for k, span in enumerate(spans):
        sid = first_id + k
        w = wins.get(sid)
        if w is None:
            raise AssertionError(f"{phase}: no window for step {sid}")
        window_us = w["end_us"] - w["begin_us"]
        card_us = span.us
        if window_us < card_us * (1.0 - WINDOW_SLACK):
            raise AssertionError(
                f"{phase}: step {sid} window {window_us} us is shorter than "
                f"its card time {card_us:.1f} us")
        dec = decs[sid]
        if sum(round(dec[x] * 1e6) for x in parts) != \
                round(dec["step_s"] * 1e6):
            raise AssertionError(f"{phase}: step {sid}: {dec} does not sum "
                                 "to its step")
        margins.append(window_us - card_us)
        rows.append({"step": sid, "window_us": window_us,
                     "card_us": card_us})
    return {"steps": len(spans), "min_margin_us": min(margins),
            "max_margin_us": max(margins), "by_step": rows}


TUNE = dict(epoch_steps=4, samples=6, warmup_epochs=1, job="chip-smoke",
            knob_micro=10, fusion=2 << 20, cycle_ms=0.5, lane=2048,
            # a 256 KiB bucket bound cuts GPT-2 small's gradients into
            # ~1900 exchanges a step, three ring events each: the ring
            # must hold a whole step to close its window
            ring=1 << 15)


def tune_gpt(device, out_dir):
    """GPT-2 small under TuningSession(default_space(engine_knobs=False)):
    bucket bytes and compression none/bf16/int8 with the accuracy guard,
    the step rebuilt from step_kwargs whenever on_step returns a config,
    the converged config published to an in-process KVServer. Each step's
    window is held to its card time. Then one step of the converged step
    against a step rebuilt fresh from the same state and kwargs."""
    import copy
    import gc
    import io
    from contextlib import redirect_stdout
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import flight_recorder as fr
    from horovod_tpu_torch.common import kv_keys
    from horovod_tpu_torch.metrics import MetricsExporter, get_registry
    from horovod_tpu_torch.models.gpt import GptSmall, lm_loss
    from horovod_tpu_torch.obs import attribution, top
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import dp
    from horovod_tpu_torch.runner.http_kv import KVClient, KVServer
    from horovod_tpu_torch.tune import TuningSession, default_space
    log_path = os.path.join(out_dir, "tune_gpt.csv")
    os.environ.update(HOROVOD_TUNE_EPOCH_STEPS=str(TUNE["epoch_steps"]),
                      HOROVOD_TUNE_SAMPLES=str(TUNE["samples"]),
                      HOROVOD_TUNE_WARMUP_EPOCHS=str(TUNE["warmup_epochs"]),
                      HOROVOD_TUNE_LOG=log_path)
    kv = KVServer().start()
    exporter = None
    fr.reset_recorder(TUNE["ring"])
    hvd.init()
    try:
        model = GptSmall(dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(device)
        layers = len(model.blocks)
        tokens = torch.randint(0, 50257, (MAIN["b"], MAIN["t"]),
                               generator=torch.Generator().manual_seed(0))
        batch = tokens.to(device)

        def adamw(params):
            return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=1e-4)
        opt = adamw(model.parameters())
        ts = TuningSession(space=default_space(engine_knobs=False),
                           kv=KVClient("127.0.0.1", kv.port),
                           job=TUNE["job"])
        step = dp.make_train_step(model, lm_loss, opt, **ts.step_kwargs())
        attr = attribution.get_attributor()
        first_id = attr._steps + 1
        # the tuner reads the ring itself at each epoch's end; the
        # attributor's background refresh (every 10th step, a parse of
        # 32768 events) would take the GIL inside the next step's events
        refresh_every, attr._every = attr._every, 0
        fa.reset_launch_counts()
        losses, spans, epochs, windows_ok = [], [], [], []
        rebuilds = 0
        cap = (TUNE["samples"] + TUNE["warmup_epochs"] + 2) * \
            TUNE["epoch_steps"]
        while not ts.converged and len(losses) < cap:
            with CardSpan(device) as span:
                out = step(batch)
            losses.append(out.loss.item())  # waits for the step
            spans.append(span)
            epoch = ts.epoch
            cfg = ts.on_step(losses[-1])
            if ts.epoch != epoch:
                epochs.append({"epoch": ts.epoch,
                               "config": dict(ts.config)})
            if cfg is not None:
                del step
                gc.collect()
                step = dp.make_train_step(model, lm_loss, opt,
                                          **ts.step_kwargs(cfg))
                rebuilds += 1
            # the window check needs each step's window: read the ring
            # after each step, whose card work has ended (.item())
            windows_ok.append(check_windows(
                "tune", fr.dump(), first_id + len(spans) - 1, [span]))
        counts = fa.launch_counts()
        attr._every = refresh_every
        # the converged step, and one rebuilt fresh from the same state
        state = copy.deepcopy({"model": model.state_dict(),
                               "opt": opt.state_dict()})
        loss_a = step(batch).loss.item()
        params_a = [p.detach().clone() for p in model.parameters()]
        fresh = GptSmall(dtype=torch.bfloat16)
        fresh.load_state_dict(state["model"])
        fresh.to(device)
        fresh_opt = adamw(fresh.parameters())
        fresh_opt.load_state_dict(state["opt"])
        fresh_step = dp.make_train_step(fresh, lm_loss, fresh_opt,
                                        **ts.step_kwargs())
        loss_b = fresh_step(batch).loss.item()
        bit_equal = loss_a == loss_b and all(
            torch.equal(a, b) for a, b in zip(params_a, fresh.parameters()))
        # the tune view of hvd-top over this process's registry
        exporter = MetricsExporter(get_registry(), port=0,
                                   labels={"rank": "0"}).start()
        view = io.StringIO()
        with redirect_stdout(view):
            top_rc = top.main(["--once", "--tune", "--targets",
                               f"127.0.0.1:{exporter.port}"])
        published = kv.get_json(kv_keys.tune_config(TUNE["job"]))
        search = ts._search
        del model, opt, step, fresh, fresh_opt, fresh_step, state
        torch.cuda.empty_cache()
    finally:
        if exporter is not None:
            exporter.stop()
        kv.stop()
        hvd.shutdown()
        fr.reset_recorder()
        for k in ("HOROVOD_TUNE_EPOCH_STEPS", "HOROVOD_TUNE_SAMPLES",
                  "HOROVOD_TUNE_WARMUP_EPOCHS", "HOROVOD_TUNE_LOG"):
            os.environ.pop(k, None)
    rows = [ln.split(",") for ln in open(log_path).read().splitlines()
            if ln and not ln.startswith(("objective", "#"))]
    steps = len(losses)
    checks = {
        "converged": ts.converged and search.samples <= TUNE["samples"],
        "csv_row_per_sample": len(rows) == search.samples,
        "kv_published": bool(published) and
        published["config"] == ts.config,
        "top_lists_rank0": top_rc == 0 and any(
            ln.split()[:1] == ["0"] and "converged" in ln
            for ln in view.getvalue().splitlines()),
        "losses_finite": all(math.isfinite(x) for x in losses),
        "launches_12_per_step": counts == {
            k: layers * steps for k in counts},
        "rebuilt_step_bit_equal": bool(bit_equal),
    }
    if not all(checks.values()):
        raise AssertionError(f"tune: {checks}; losses {losses}; counts "
                             f"{counts}; top {view.getvalue()!r}")
    return counts, {
        "steps": steps, "rebuilds": rebuilds, "losses": losses,
        "samples": search.samples,
        "trace": [{"config": t["config"], "objective_s": t["objective"],
                   "phase": t["phase"]} for t in search.trace],
        "csv": [{"objective_s": float(r[0]), "source": r[1],
                 "bucket_bytes": r[2], "compression": r[9]} for r in rows],
        "epochs": epochs, "converged_config": dict(ts.config),
        "best_objective_s": search.best_objective,
        "published": published, "top_tune": view.getvalue(),
        "windows": {"steps": len(windows_ok),
                    "min_margin_us": min(w["min_margin_us"]
                                         for w in windows_ok),
                    "window_us": [w["by_step"][0]["window_us"]
                                  for w in windows_ok],
                    "card_us": [w["by_step"][0]["card_us"]
                                for w in windows_ok]},
        "fresh_step_loss": [loss_a, loss_b], "checks": checks}


def knob_run(device, push=False, timeline=None, autotune=None,
             micro=TUNE["knob_micro"]):
    """GPT-2 small's loop as in phase obs (broadcast_parameters,
    DistributedOptimizer(AdamW, bf16 wire, two backward passes a step),
    each microstep's loss through metric_average, an eager allreduce),
    under the eager plane's knobs: a push of TUNE's fusion, cycle and
    lane before the loop, HOROVOD_TIMELINE with a torch profiler trace of
    one microstep, or HOROVOD_AUTOTUNE. The parameters, the losses, the
    knobs in force, and the cache's lookups per microstep."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import eager
    from horovod_tpu_torch.models.gpt import GptSmall, lm_loss
    env = {}
    if timeline:
        env.update(HOROVOD_TIMELINE=timeline)
    if autotune:
        env.update(HOROVOD_AUTOTUNE="1", HOROVOD_AUTOTUNE_LOG=autotune,
                   HOROVOD_AUTOTUNE_WARMUP_SAMPLES="1",
                   HOROVOD_AUTOTUNE_STEPS="3",
                   HOROVOD_AUTOTUNE_SAMPLE_CYCLES="2")
    os.environ.update(env)
    prof_path = None
    hvd.init()
    try:
        model = GptSmall(dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(device)
        gen = torch.Generator().manual_seed(1)
        batches = [torch.randint(0, 50257, (MAIN["b"], MAIN["t"]),
                                 generator=gen).to(device) for _ in range(2)]
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=FRONT["lr"],
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=FRONT["weight_decay"]),
            compression=hvd.Compression.bf16,
            backward_passes_per_step=FRONT["bpps"])
        ex = eager.get_executor()
        if push:
            eager.set_tuned_params(cycle_time_ms=TUNE["cycle_ms"],
                                   fusion_threshold_bytes=TUNE["fusion"],
                                   low_latency_threshold_bytes=TUNE["lane"],
                                   express_lane=True)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        adopted_round = ex.params_round
        lookups = []
        losses = []

        def microstep(b):
            opt.zero_grad(set_to_none=True)
            loss = lm_loss(model, b)[0]
            loss.backward()
            opt.step()
            return float(hvd.metric_average(loss.detach()))

        for k in range(micro):
            h0, m0 = ex._c_hits.value, ex._c_misses.value
            if timeline and k == micro - 1:
                prof_path = timeline + ".torch_trace.json"
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    losses.append(microstep(batches[k % 2]))
                prof.export_chrome_trace(prof_path)
            else:
                losses.append(microstep(batches[k % 2]))
            lookups.append((ex._c_hits.value - h0,
                            ex._c_misses.value - m0))
        params = [p.detach().clone() for p in model.parameters()]
        knobs = eager.tuned_params()
        n_bcast = len(model.state_dict())
    finally:
        hvd.shutdown()  # stops the executor: the timeline file closes
        for k in env:
            os.environ.pop(k, None)
    return {"params": params, "losses": losses, "knobs": knobs,
            "adopted_round": adopted_round, "lookups": lookups,
            "prof_path": prof_path, "n_bcast": n_bcast}


def engine_knobs(device, out_dir):
    """The eager plane's knobs at world 1 on GPT-2 small's loop: a run
    without them (A), with the push (B: adopted at one round, parameters
    bit-equal to A, the cache's hit rate after the first microstep), with
    HOROVOD_TIMELINE (C: merged with the torch profiler's trace by
    profiler/trace_merge; every broadcast and allreduce of the loop has
    its exec), with HOROVOD_AUTOTUNE (D: its CSV, the parameters exact,
    the knobs within their bounds)."""
    import torch
    from horovod_tpu_torch.common import parameter_manager as pm
    from horovod_tpu_torch.profiler import trace_merge
    tl_path = os.path.join(out_dir, "tune_timeline.json")
    at_path = os.path.join(out_dir, "tune_autotune.csv")
    a = knob_run(device)
    b = knob_run(device, push=True)
    c = knob_run(device, timeline=tl_path)
    d = knob_run(device, autotune=at_path)

    def same(x, y):
        return all(torch.equal(p, q) for p, q in zip(x["params"],
                                                     y["params"]))
    pushed = dict(cycle_time_ms=TUNE["cycle_ms"],
                  fusion_threshold_bytes=TUNE["fusion"],
                  low_latency_threshold_bytes=TUNE["lane"], express_lane=1)
    after = b["lookups"][1:]
    hit_rate = sum(h for h, _ in after) / max(1, sum(h + m
                                                     for h, m in after))
    merged = trace_merge.merge_traces(tl_path, c["prof_path"],
                                      os.path.join(out_dir,
                                                   "tune_merged.json"))
    engine = [e for e in merged["traceEvents"]
              if e.get("pid") == trace_merge.DEFAULT_ENGINE_PID]
    lane_name = {e["tid"]: e["args"]["name"] for e in engine
                 if e.get("ph") == "M" and e.get("name") == "thread_name"}
    execs = {}
    for e in engine:
        if e.get("ph") == "B" and str(e.get("name")).startswith("EXEC_"):
            execs.setdefault(e["name"], set()).add(lane_name[e["tid"]])
    bcasts = {n for n in execs.get("EXEC_BROADCAST", ())
              if n.startswith("bcast_params.")}
    card_events = [e for e in merged["traceEvents"]
                   if e.get("pid") != trace_merge.DEFAULT_ENGINE_PID and
                   e.get("cat") == "kernel"]
    at_rows = [ln for ln in open(at_path).read().splitlines()[1:]
               if ln and not ln.startswith("#")]
    dk = d["knobs"]
    checks = {
        "push_adopted": all(b["knobs"][k] == v for k, v in pushed.items())
        and b["adopted_round"] > 0,
        "push_bit_equal": same(a, b) and a["losses"] == b["losses"],
        "timeline_parses": len(engine) > 0 and len(card_events) > 0,
        "timeline_every_broadcast": len(bcasts) == c["n_bcast"],
        "timeline_every_metric_average": "metric_average" in
        execs.get("EXEC_ALLREDUCE", ()),
        "timeline_bit_equal": same(a, c),
        "autotune_csv": open(at_path).readline().startswith(
            "score_bytes_per_sec") and len(at_rows) >= 1,
        "autotune_bit_equal": same(a, d) and a["losses"] == d["losses"],
        "autotune_in_bounds":
            pm.CYCLE_MS[0] <= dk["cycle_time_ms"] <= pm.CYCLE_MS[1] and
            pm.FUSION_BYTES[0] <= dk["fusion_threshold_bytes"] <=
            pm.FUSION_BYTES[1],
    }
    if not all(checks.values()):
        raise AssertionError(f"tune knobs: {checks}")
    return {"push": {"knobs": b["knobs"], "adopted_round":
                     b["adopted_round"]},
            "cache_hit_rate_after_first_microstep": hit_rate,
            "cache_lookups_by_microstep": b["lookups"],
            "timeline": {"engine_events": len(engine),
                         "card_kernel_events": len(card_events),
                         "broadcast_lanes": len(bcasts),
                         "exec_kinds": sorted(execs)},
            # the converged choice is logged at once and takes effect
            # with the round after it, if the loop runs one
            "autotune": {"rows": at_rows, "knobs_in_force": dk,
                         "logged_converged":
                             "# converged" in open(at_path).read()},
            "checks": checks}


def step_mark_cost(iters=5000) -> dict:
    """Host µs of one step's STEP_BEGIN + STEP_END on the card (two
    records and the two timing events of its window) and of the two
    events alone, on a ring of its own."""
    from horovod_tpu_torch.common import flight_recorder as fr
    rec = fr.FlightRecorder(4096)
    t0 = time.perf_counter()
    for i in range(iters):
        rec.step_begin(i)
        rec.step_end(i)
    pair = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fr._card_event()
        fr._card_event()
    events = (time.perf_counter() - t0) / iters
    return {"marks_us_per_step": pair * 1e6,
            "events_us_per_step": events * 1e6, "iters": iters}


def tune_phase(device, card, out_dir):
    """Phase tune: the tuned GPT-2 small, the eager plane's knobs on its
    loop, and the express lane's cliff report on the card."""
    from horovod_tpu_torch.ops import flash_attention as fa
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.serve.loadgen import small_tensor_cliff_report
    import tempfile
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tune-") as tmp:
        # the CSV logs, the timeline and its merge: kept with --out
        out_dir = out_dir or tmp
        os.makedirs(out_dir, exist_ok=True)
        fa.reset_launch_counts()
        gpt_counts, gpt = tune_gpt(device, out_dir)
        knobs = engine_knobs(device, out_dir)
    hvd.init()
    try:
        cliff = small_tensor_cliff_report()
        marks = step_mark_cost()
    finally:
        hvd.shutdown()
    if not cliff["bit_equal"] or \
            cliff["serving_mode"]["low_latency_responses"] != \
            cliff["serving_mode"]["iters"]:
        raise AssertionError(f"tune: express lane {cliff}")
    counts = fa.launch_counts()
    return counts, {
        "phase": "tune", "nvidia_smi": card, "model": "GptSmall",
        "batch": MAIN["b"], "seq": MAIN["t"], "gpt": gpt,
        "gpt_launches": gpt_counts, "knobs": knobs, "cliff": cliff,
        "step_marks": marks,
        "launches": counts, "seconds": time.perf_counter() - t_phase}


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


# ---------------------------------------------------------------------------
# elastic training: GPT-2 small under elastic.run recovering from a fault

ELASTIC = dict(steps=8, commit_every=2, fault_after=5, lr=3e-4,
               weight_decay=1e-4, timeout_s=30, sequences=64)


def elastic_batch(step: int):
    import torch
    return torch.randint(0, 50257, (MAIN["b"], MAIN["t"]),
                         generator=torch.Generator().manual_seed(1000 + step))


def elastic_model(device):
    import torch
    from horovod_tpu_torch.models.gpt import GptSmall
    model = GptSmall(dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(device)


def elastic_adamw(params):
    import torch
    return torch.optim.AdamW(params, lr=ELASTIC["lr"], betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=ELASTIC["weight_decay"])


def elastic_make_step(model, sharded: bool, opt=None):
    """(optimizer, train step) on the job as it is now: what a re-init or
    a resize rebuilds. ZeRO-1 always builds a ShardedOptimizer for the
    current world; the replicated step takes ``opt`` when given."""
    from horovod_tpu_torch.models.gpt import lm_loss
    from horovod_tpu_torch.parallel import dp, zero
    if sharded:
        opt = zero.sharded_optimizer(model, elastic_adamw)
        return opt, dp.make_train_step(model, lm_loss, opt,
                                       sharded_update=True)
    opt = opt or elastic_adamw(model.parameters())
    return opt, dp.make_train_step(model, lm_loss, opt)


def elastic_final(model, opt, sharded: bool) -> dict:
    """Parameters and optimizer state on the host, for bit comparison."""
    out = {f"param/{k}": v.detach().cpu() for k, v in
           model.state_dict().items()}
    states = [opt.optimizer.state[s] for s in opt.shards] if sharded else \
        [opt.state[p] for p in model.parameters()]
    for i, st in enumerate(states):
        for k, v in st.items():
            out[f"opt{i}/{k}"] = v.detach().cpu() if hasattr(v, "cpu") \
                else v
    return out


def elastic_bit_equal(got: dict, want: dict) -> bool:
    import torch
    return got.keys() == want.keys() and all(
        torch.equal(got[k], want[k]) if isinstance(want[k], torch.Tensor)
        else got[k] == want[k] for k in want)


def elastic_yardstick(device, sharded: bool) -> dict:
    """Run A: the same steps with no fault and without elastic.run."""
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        model = elastic_model(device)
        opt, step = elastic_make_step(model, sharded)
        losses = [step(elastic_batch(s)).loss.item()
                  for s in range(ELASTIC["steps"])]
        return {"final": elastic_final(model, opt, sharded),
                "losses": losses}
    finally:
        hvd.shutdown()


def elastic_run(device, kind: str) -> dict:
    """One elastic run of GPT-2 small: ``kind`` "B" (State, AdamW, the
    default NCCL group aborted after step 5), "C" (State, a hosts-updated
    notice before the step-4 commit), "D" (ShardedState, ZeRO-1 AdamW,
    the fault of B) or "F" (D's job, the fault injected by
    HOROVOD_FAULT_SPEC at step 6's reduce-scatter). Recovery is timed in
    its parts: detection (the abort, or the start of the faulted step, to
    the HorovodInternalError out of the step), teardown (shutdown),
    re-init (init) and sync. Run D also counts the data sends before step
    6 and names step 1's (``info["probe"]``): run F's frame."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.common import basics, fault_injector as fi
    from horovod_tpu_torch.metrics import get_registry
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import collectives
    sharded = kind in "DF"
    marks = {"teardown_s": 0.0, "reinit_s": 0.0, "sync_s": 0.0}
    info = {"attempts": 0, "fault": None, "pg_recreated": False}
    sends = []  # run D: the (point, collective) of step 1's data points

    def spy(point):
        sends.append((point, getattr(collectives._tls, "scope", None)))
        return spy.inner(point)
    spy.inner = collectives._inject

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                marks[name] += time.perf_counter() - t0
        return run

    shutdown, init = basics.shutdown, basics.init
    basics.shutdown = timed("teardown_s", shutdown)
    basics.init = timed("reinit_s", init)
    hvd.init()
    try:
        model = elastic_model(device)
        opt, step_fn = elastic_make_step(model, sharded)
        first_pg = dist.distributed_c10d._get_default_group()

        class Elastic(elastic.ShardedState if sharded else elastic.State):
            def on_reset(self):
                # the new process groups' step; ZeRO-1 also rebuilds its
                # optimizer at the new world (sync loads the moments)
                self.opt, self.step_fn = elastic_make_step(
                    model, sharded, None if sharded else self.opt)

            def sync(self):
                t0 = time.perf_counter()
                super().sync()
                if sharded:
                    self.load_optimizer(self.opt)
                marks["sync_s"] += time.perf_counter() - t0

        if sharded:
            state = Elastic.for_optimizer(opt, model=model, step=0)
        else:
            state = Elastic(model=model, optimizer=opt, step=0)
        state.opt, state.step_fn = opt, step_fn
        t_fault = []
        commits_ms = []

        @elastic.run
        def train(state):
            while state.step < ELASTIC["steps"]:
                if kind in "BDF" and state.step == ELASTIC["fault_after"] \
                        and not t_fault:
                    torch.cuda.synchronize()
                    t_fault.append(time.perf_counter())
                    if kind == "D":
                        info["probe"] = {
                            "sends_before": fi.get_injector().injected,
                            "step_sends": [sc for p, sc in sends
                                           if p == "send"]}
                    if kind in "BD":
                        # the fault: the default NCCL group's
                        # communicators aborted from outside the step
                        dist.distributed_c10d._get_default_group().abort()
                info["attempts"] += 1
                if kind == "D" and state.step == 0 and not sends:
                    collectives._inject = spy
                before = fa.launch_counts()
                try:
                    state.step_fn(elastic_batch(state.step))
                except elastic.HorovodInternalError as err:
                    info["fault"] = {"type": type(err).__name__,
                                     "cause": type(err.__cause__).__name__,
                                     "message": str(err)[:300],
                                     "detection_s": time.perf_counter() -
                                     t_fault[0],
                                     # F's fault stops the backward at the
                                     # first reduce-scatter's issue
                                     "attempt_launches": {
                                         k: v - before[k] for k, v in
                                         fa.launch_counts().items()}}
                    raise
                finally:
                    collectives._inject = spy.inner
                state.step += 1
                if state.step % ELASTIC["commit_every"] == 0:
                    if kind == "C" and state.step == 4 and not t_fault:
                        t_fault.append(time.perf_counter())
                        elastic.notify_hosts_updated(generation=None)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state.commit()
                    torch.cuda.synchronize()
                    commits_ms.append((time.perf_counter() - t0) * 1e3)

        reg = get_registry()
        before = reg.histogram(elastic.RECOVERY_SECONDS).snapshot()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        train(state)
        torch.cuda.synchronize()
        after = reg.histogram(elastic.RECOVERY_SECONDS).snapshot()
        info["pg_recreated"] = \
            dist.distributed_c10d._get_default_group() is not first_pg
        final = elastic_final(model, state.opt, sharded)
        peak = torch.cuda.max_memory_allocated()
    finally:
        basics.shutdown, basics.init = shutdown, init
        hvd.shutdown()
    return {"final": final, "info": info, "marks": marks,
            "commit_ms": commits_ms, "peak_mem_bytes": peak,
            "recovery_seconds": after.sum - before.sum,
            "recoveries": after.count - before.count}


def elastic_dataset():
    import torch
    return torch.randint(0, 50257, (ELASTIC["sequences"], MAIN["t"]),
                         generator=torch.Generator().manual_seed(2000))


def elastic_hook_run(device, fault: bool) -> dict:
    """Run E (``fault``) or its run A: GPT-2 small through the PyTorch
    frontend's hook-driven DistributedOptimizer(AdamW, named_parameters)
    over an ElasticSampler of ELASTIC["sequences"] seeded sequences, batch
    8, one epoch, TorchState(model, optimizer, sampler) committed every 2
    steps. Run E runs under elastic.run and, after step 5, aborts the
    default NCCL group as run B does and the eager plane's data group,
    which the hooks' reductions run on; run A neither. Returns the final
    parameters and moments, the samples each step trained on (a redone
    step's replacing its first attempt's), the processed set, and the
    attempts."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch.torch as thvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.metrics import get_registry
    from horovod_tpu_torch.models.gpt import lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    data = elastic_dataset()
    b_size = MAIN["b"]
    info = {"attempts": 0, "fault": None, "pg_recreated": False}
    thvd.init()
    try:
        model = elastic_model(device)
        opt = thvd.DistributedOptimizer(
            elastic_adamw(model.parameters()),
            named_parameters=model.named_parameters())
        sampler = thvd.elastic.ElasticSampler(data, shuffle=True, seed=0)
        state = thvd.elastic.TorchState(model=model, optimizer=opt,
                                        sampler=sampler, step=0)
        first_pg = basics._ctx.eager_groups[1]
        trained_on, t_fault = {}, []

        def train(state):
            b = 0  # batches of the sampler's indices, dealt anew on reset
            while state.step < ELASTIC["steps"]:
                if fault and state.step == ELASTIC["fault_after"] \
                        and not t_fault:
                    torch.cuda.synchronize()
                    t_fault.append(time.perf_counter())
                    dist.distributed_c10d._get_default_group().abort()
                    basics._ctx.eager_groups[1].abort()
                info["attempts"] += 1
                idx = sampler.indices[b * b_size:(b + 1) * b_size]
                before = fa.launch_counts()
                try:
                    opt.zero_grad()
                    lm_loss(model, data[idx].to(device))[0].backward()
                    opt.step()
                except elastic.HorovodInternalError as err:
                    info["fault"] = {"type": type(err).__name__,
                                     "message": str(err)[:300],
                                     "detection_s": time.perf_counter() -
                                     t_fault[0],
                                     # the first failed reduction aborts
                                     # the eager plane, whose next hook
                                     # submit raises inside the backward
                                     "attempt_launches": {
                                         k: v - before[k] for k, v in
                                         fa.launch_counts().items()}}
                    raise
                sampler.record_batch(b, b_size)
                trained_on[state.step] = list(idx)
                b += 1
                state.step += 1
                if state.step % ELASTIC["commit_every"] == 0:
                    state.commit()

        reg = get_registry()
        before = reg.histogram(elastic.RECOVERY_SECONDS).snapshot()
        (elastic.run(train) if fault else train)(state)
        torch.cuda.synchronize()
        after = reg.histogram(elastic.RECOVERY_SECONDS).snapshot()
        info["pg_recreated"] = basics._ctx.eager_groups[1] is not first_pg
        final = elastic_final(model, opt, False)
        processed = sorted(sampler.processed_indices)
    finally:
        thvd.shutdown()
    return {"final": final, "info": info, "trained_on": trained_on,
            "processed": processed,
            "recovery_seconds": after.sum - before.sum,
            "recoveries": after.count - before.count}


def elastic_phase(device, card):
    """The elastic phase: runs A (and its ZeRO-1 and hook-driven
    counterparts), B, C, D, E and F."""
    from horovod_tpu_torch.common import fault_injector
    from horovod_tpu_torch.ops import flash_attention as fa
    os.environ["HOROVOD_GLOO_TIMEOUT_SECONDS"] = str(ELASTIC["timeout_s"])
    yard = {"replicated": elastic_yardstick(device, sharded=False),
            "zero1": elastic_yardstick(device, sharded=True),
            "hook_driven": elastic_hook_run(device, fault=False)}
    os.environ["HOROVOD_ELASTIC"] = "1"
    os.environ["HOROVOD_ELASTIC_RETRY_BACKOFF_SECONDS"] = "0"
    counts = {k: 0 for k in NAMES}
    runs, attempts = {}, 0
    frame = None
    try:
        for kind in "BCDEF":
            if kind == "D":
                # every data send counted, none held (delay 0)
                os.environ["HOROVOD_FAULT_SPEC"] = "data.send:delay_ms=0"
            elif kind == "F":
                # the drop at step 6's reduce-scatter: D's sends before
                # step 6, then step 1's before its reduce-scatter
                probe = runs["D"]["info"]["probe"]
                frame = probe["sends_before"] + next(
                    i for i, sc in enumerate(probe["step_sends"])
                    if (sc or "").startswith("hvd_reducescatter"))
                os.environ["HOROVOD_FAULT_SPEC"] = \
                    f"data.send:drop@frame={frame}"
            fa.reset_launch_counts()
            try:
                runs[kind] = elastic_hook_run(device, fault=True) \
                    if kind == "E" else elastic_run(device, kind)
            finally:
                os.environ.pop("HOROVOD_FAULT_SPEC", None)
                fault_injector.set_fault_spec("")
            for k, v in fa.launch_counts().items():
                counts[k] += v
            attempts += runs[kind]["info"]["attempts"]
    finally:
        for name in ("HOROVOD_ELASTIC",
                     "HOROVOD_ELASTIC_RETRY_BACKOFF_SECONDS",
                     "HOROVOD_GLOO_TIMEOUT_SECONDS"):
            os.environ.pop(name, None)
    layers = 12
    # the launches the faulted attempts left out
    short = {k: sum(layers - r["info"]["fault"]["attempt_launches"][k]
                    for r in runs.values()
                    if "attempt_launches" in (r["info"]["fault"] or {}))
             for k in counts}
    want_counts = {k: layers * attempts - short[k] for k in counts}
    if counts != want_counts or short["flash_fwd"]:
        raise AssertionError(f"elastic: launches {counts}, want "
                             f"{want_counts}")
    line = {"phase": "elastic", "nvidia_smi": card, "backend": "nccl",
            "world_size": 1, "model": "GptSmall", "batch": MAIN["b"],
            "seq": MAIN["t"], "steps": ELASTIC["steps"],
            "commit_every": ELASTIC["commit_every"],
            "group_timeout_s": ELASTIC["timeout_s"],
            "yardstick_losses": yard["replicated"]["losses"],
            "launches": counts, "step_attempts": attempts,
            "launches_short_of_faulted_attempts": short, "runs": {}}
    want = {"B": "replicated", "C": "replicated", "D": "zero1",
            "E": "hook_driven", "F": "zero1"}
    redone = {"B": ELASTIC["fault_after"] - 4, "C": 0, "D": 0,
              "E": ELASTIC["fault_after"] - 4, "F": 0}
    for kind, r in runs.items():
        equal = elastic_bit_equal(r["final"], yard[want[kind]]["final"])
        info, marks = r["info"], r.get("marks", {})
        entry = {
            "against": want[kind], "bit_equal": equal,
            "steps_redone": info["attempts"] - ELASTIC["steps"] -
            (1 if info["fault"] else 0),
            "step_attempts": info["attempts"], "fault": info["fault"],
            "pg_recreated": info["pg_recreated"],
            "recoveries": r["recoveries"],
            "hvd_elastic_recovery_seconds": r["recovery_seconds"],
            "recovery_split_s": {
                "detection": (info["fault"] or {}).get("detection_s", 0.0),
                **{k[:-2]: v for k, v in marks.items()}},
            "commit_ms": r.get("commit_ms"),
            "peak_mem_bytes": r.get("peak_mem_bytes")}
        if kind == "E":
            # every sample of the epoch in exactly one of the steps kept
            samples = sorted(i for idx in r["trained_on"].values()
                             for i in idx)
            entry["samples_once"] = samples == list(
                range(ELASTIC["sequences"])) and \
                r["processed"] == samples
            entry["steps_kept"] = len(r["trained_on"])
            if not entry["samples_once"]:
                raise AssertionError(f"elastic run E: samples {samples}, "
                                     f"processed {r['processed']}")
        line["runs"][kind] = entry
        if not equal:
            raise AssertionError(f"elastic run {kind}: not bit-equal to "
                                 f"run A ({want[kind]})")
        if entry["steps_redone"] != redone[kind]:
            raise AssertionError(f"elastic run {kind}: redid "
                                 f"{entry['steps_redone']} steps, want "
                                 f"{redone[kind]}")
        if r["recoveries"] != 1 or not info["pg_recreated"]:
            raise AssertionError(f"elastic run {kind}: {r['recoveries']} "
                                 "recoveries, process group recreated "
                                 f"{info['pg_recreated']}")
        if kind in "BDEF" and (info["fault"] or {}).get("type") != \
                "HorovodInternalError":
            raise AssertionError(f"elastic run {kind}: fault {info}")
        if kind == "F":
            entry["injected"] = {"spec": f"data.send:drop@frame={frame}",
                                 "sends_per_step":
                                 len(runs["D"]["info"]["probe"]
                                     ["step_sends"])}
            if "injected fault (data.send" not in info["fault"]["message"]:
                raise AssertionError(f"elastic run F: fault {info}")
    return counts, line


# ---------------------------------------------------------------------------
# the fault-tolerance surface at world 1: HOROVOD_FAULT_SPEC, the fast abort

FAULTS = dict(delay_ms=200, warm=2, steps=3, pending_delay_ms=500)
# the reference's own specs (tests/test_fault_tolerance.py:66-88)
FAULT_SPECS_OK = (
    "ring_send:drop@frame=7;recv:delay_ms=500@prob=0.1;"
    "frame:corrupt@frame=12",
    "data.send:corrupt@frame=0,rank=1;control.connect:fail@count=3", "")
FAULT_SPECS_BAD = ("nonsense", "send:explode", "send:drop@frame=x",
                   "bogus_point:drop", "send:delay_ms=-5",
                   "send:drop@prob=1.5")


def faults_phase(device, card):
    """Phase faults: the grammar (the reference's specs accepted and its
    malformed ones refused naming HOROVOD_FAULT_SPEC, by set_fault_spec
    and by init()); GPT-2 small's replicated step on NCCL timed without
    and with ``data.send:delay_ms=D`` (every data send of the step held D
    ms on the host: the step must take at least the held time longer);
    an eager allreduce held pending by ``control.send:delay_ms=`` and
    failed by ``abort(reason)`` with the reason; faults_injected and
    aborts counted; the kernels' launches of the phase's steps."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import eager, fault_injector as fi
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    from horovod_tpu_torch.metrics.registry import engine_counters
    from horovod_tpu_torch.models.gpt import GptSmall, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import dp
    refused = {}
    for spec in FAULT_SPECS_OK:
        fi.set_fault_spec(spec)
    for spec in FAULT_SPECS_BAD:
        try:
            fi.set_fault_spec(spec)
            raise AssertionError(f"faults: {spec!r} accepted")
        except ValueError as err:
            if "HOROVOD_FAULT_SPEC" not in str(err):
                raise
            refused[spec] = str(err)
    fi.set_fault_spec("")
    os.environ["HOROVOD_FAULT_SPEC"] = FAULT_SPECS_BAD[1]
    try:
        hvd.init()
        raise AssertionError("faults: init() took a malformed spec")
    except HorovodInternalError as err:
        init_refused = str(err)
    finally:
        del os.environ["HOROVOD_FAULT_SPEC"]
    if hvd.is_initialized():
        raise AssertionError("faults: init() went on after refusing")
    c0 = engine_counters()
    fa.reset_launch_counts()
    hvd.init()
    try:
        model = GptSmall(dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(0))
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4)
        step = dp.make_train_step(model, lm_loss, opt)
        batch = elastic_batch(0).to(device)

        def timed():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(batch)
            loss = out.loss.item()
            return (time.perf_counter() - t0) * 1e3, loss
        for _ in range(FAULTS["warm"]):
            timed()
        base = [timed()[0] for _ in range(FAULTS["steps"])]
        before = engine_counters()["faults_injected"]
        fi.set_fault_spec(f"data.send:delay_ms={FAULTS['delay_ms']}")
        try:
            held_ms, held_loss = timed()
        finally:
            fi.set_fault_spec("")
        sends = engine_counters()["faults_injected"] - before
        after = [timed()[0] for _ in range(FAULTS["steps"])]
        base_ms = statistics.median(base + after)
        # the held time shows, less at most one step the card overlaps
        if sends < 1 or held_ms - base_ms < sends * FAULTS["delay_ms"] - \
                base_ms or not math.isfinite(held_loss):
            raise AssertionError(
                f"faults: {sends} held sends of {FAULTS['delay_ms']} ms, "
                f"step {held_ms:.1f} ms against {base_ms:.1f} ms")
        # an eager op pending in a round held at control.send, aborted
        fi.set_fault_spec(f"control.send:delay_ms="
                          f"{FAULTS['pending_delay_ms']}")
        try:
            h = eager.allreduce_async(torch.ones(4, device=device),
                                      name="faults.pending")
            time.sleep(0.05)
            pending = not eager.poll(h)
            t0 = time.perf_counter()
            eager.abort("chip smoke abort")
            try:
                eager.synchronize(h, timeout=10.0)
                raise AssertionError("faults: the aborted op completed")
            except HorovodInternalError as err:
                abort_ms = (time.perf_counter() - t0) * 1e3
                abort_msg = str(err)
            if "chip smoke abort" not in abort_msg or not pending:
                raise AssertionError(f"faults: pending {pending}, "
                                     f"{abort_msg}")
            healthy = eager.healthy()
        finally:
            fi.set_fault_spec("")
    finally:
        hvd.shutdown()
    counters = {k: v - c0[k] for k, v in engine_counters().items()}
    if counters["aborts"] != 1 or counters["faults_injected"] < sends + 1 \
            or healthy:
        raise AssertionError(f"faults: counters {counters}, healthy "
                             f"{healthy}")
    counts = fa.launch_counts()
    attempts = FAULTS["warm"] + 2 * FAULTS["steps"] + 1
    if counts != {k: 12 * attempts for k in NAMES}:
        raise AssertionError(f"faults: launches {counts}")
    return counts, {
        "phase": "faults", "nvidia_smi": card, "backend": "nccl",
        "world_size": 1, "model": "GptSmall", "batch": MAIN["b"],
        "seq": MAIN["t"], "refused": refused, "init_refused": init_refused,
        "accepted": list(FAULT_SPECS_OK),
        "delay": {"spec": f"data.send:delay_ms={FAULTS['delay_ms']}",
                  "sends_held": sends, "step_ms": base_ms,
                  "held_step_ms": held_ms, "extra_ms": held_ms - base_ms,
                  "step_ms_each": base + after},
        "abort": {"pending_before": pending, "ms_to_fail": abort_ms,
                  "message": abort_msg[:200], "healthy_after": healthy},
        "counters": counters, "launches": counts}


# ---------------------------------------------------------------------------
# the serving plane: the TP LM at GPT-2 small's widths behind the batcher,
# the serving loop and the HTTP frontend; the fast path on the recurrent LM

SERVE_GPT = dict(vocab=50257, hidden=768, mlp_dim=3072, layers=12, seed=0)
SERVE = dict(batch=8, parity_bucket=256, parity_max_len=200,
             buckets=(32, 256, 1024, 2048), step_calls=20, http_requests=32,
             http_clients=4, prompt_min=8, prompt_max=200, new_tokens=16,
             deadline_ms=30000.0, drain_requests=8)
SERVE_FAST = dict(hidden=192, vocab=256, block_tokens=16, pool_blocks=256,
                  spec_k=4, prefix_len=160, tail_len=16, new_tokens=16,
                  tenants=4, pin_prompts=16, offered_qps=60.0,
                  window_s=3.0, deadline_ms=1500.0)


def serve_prompts(n, lo, hi, vocab, seed=0):
    """``n`` prompts of ``lo`` to ``hi`` tokens from ``seed``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, rng.randint(lo, hi + 1)).tolist()
            for _ in range(n)]


def serve_batch(prompts, bucket, batch):
    """The batch the serving loop builds: prompts in the first rows,
    padding rows one token long."""
    import numpy as np
    tokens = np.zeros((batch, bucket), np.int32)
    lengths = np.ones(batch, np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        lengths[i] = len(p)
    return tokens, lengths


def serve_greedy(step, prompt, new_tokens, bucket, batch):
    """One request decoded alone through ``step``, laid out as the loop
    lays out a batch."""
    seq = list(prompt)
    for _ in range(new_tokens):
        tokens, lengths = serve_batch([seq], bucket, batch)
        seq.append(int(step(tokens, lengths)[0]))
    return seq[len(prompt):]


# the codec's block (compression.Compression.int8, the quantized ops'
# default)
SERVE_INT8_BLOCK = 256


def serve_codec_bound(parts, block=SERVE_INT8_BLOCK):
    """Per element, the int8 wire's bound on |wire(sum parts) - sum parts|
    for the row-parallel partial sums ``parts`` of the ``world`` ranks:
    the reduce-scatter rounds each rank's block to the nearest of 127
    levels of its max|block| (within max|block| / 254), the all-gather
    rounds the reduced block again (within its own max / 254, itself at
    most the first round's error above the exact sum's). Blocks are 256
    consecutive elements of the flattened, zero-padded tensor, as
    ``quantized_allreduce`` lays them out at every world."""
    import torch
    world = len(parts)
    total = parts[0] if world == 1 else sum(parts)
    n = total.numel()
    pad = (-n) % (world * block)

    def block_max(t):
        flat = torch.nn.functional.pad(t.reshape(-1), (0, pad))
        return flat.reshape(-1, block).abs().amax(-1)
    first = sum(block_max(p) for p in parts) / 254
    per_block = first + (block_max(total) + first) / 254
    # the fp32 rounding of the scales, the dequantized products and the
    # sum, a few ulps of the block's magnitude
    per_block = per_block * (1 + 1e-5) + 1e-6 * block_max(total)
    return per_block.repeat_interleave(block)[:n].reshape(total.shape)


def serve_int8_probe(model, tokens, lengths, world=1, wire_axis=False):
    """The int8 wire of the TP LM ``model`` (one device, whole weights)
    followed layer by layer, and the bound it puts on the logits.

    At every layer the row-parallel partial sums of ``world`` ranks (the
    weights' column and row shards) give the codec's bound per element
    (:func:`serve_codec_bound`). With ``wire_axis`` (None or a model axis
    of one: ``model.axis``) the reduction runs through
    ``quantized_allreduce`` as ``TpLm`` runs it: every element must lie
    within its bound, and the wire's output must equal, bit for bit, the
    CPU's codec (``axis=None``) applied to the same values (a wrong block
    scale or rounding on the device fails here). The residual then takes
    the wire's output, so the probe's logits are the int8 step's.
    Without ``wire_axis`` the residual stays fp32. The bound on
    |int8 - fp32| logits of row b is, to first order, the sum over the
    layers of the largest bound at b's last live position, carried
    through the final LayerNorm and the tied head by their Jacobian's
    row-sum norm: max_v sum_d |(E J_LN)_vd|, J_LN = (I - 11^T/d -
    x_hat x_hat^T/d) / sigma. The later layers' response to a layer's
    error is left out (first order). Returns ``(logits [B, V], bound
    [B], worst codec ratio or None, per-layer block maxima)``."""
    import torch
    from horovod_tpu_torch.parallel import collectives
    from horovod_tpu_torch.serve.executor import _ln
    dev = model.embed.device
    tok = torch.as_tensor(tokens, device=dev).long()
    lens = torch.as_tensor(lengths, device=dev).long()
    rows = torch.arange(tok.shape[0], device=dev)
    last = (lens - 1).clamp(0, tok.shape[1] - 1)
    drift = torch.zeros(tok.shape[0], device=dev)
    worst, maxima = None, []
    with torch.no_grad():
        x = model.embed[tok]
        for w_in, w_out in zip(model.w_in, model.w_out):
            h, per = _ln(x), w_in.shape[1] // world
            parts = [torch.tanh(h @ w_in[:, r * per:(r + 1) * per]) @
                     w_out[r * per:(r + 1) * per] for r in range(world)]
            bound = serve_codec_bound(parts)
            y = parts[0] if world == 1 else sum(parts)
            maxima.append(float(y.abs().max()))
            if wire_axis is not False:
                wired = collectives.quantized_allreduce(
                    y, op=collectives.Sum, axis=wire_axis,
                    block_size=SERVE_INT8_BLOCK)
                ratio = float(((wired - y).abs() / bound).max())
                worst = ratio if worst is None else max(worst, ratio)
                if ratio > 1.0:
                    raise AssertionError(
                        f"serve: the int8 wire is {ratio:.3f} x the "
                        f"codec's bound at layer {len(maxima) - 1}")
                on_cpu = collectives.quantized_allreduce(
                    y.cpu(), op=collectives.Sum, axis=None,
                    block_size=SERVE_INT8_BLOCK)
                if not torch.equal(wired.cpu(), on_cpu):
                    raise AssertionError(
                        f"serve: the int8 wire differs from the CPU's "
                        f"codec on the same values at layer "
                        f"{len(maxima) - 1}")
                y = wired
            drift += bound[rows, last].amax(-1)
            x = x + y
        xl = x[rows, last]
        logits = _ln(xl) @ model.embed.t()
        d = xl.shape[-1]
        sigma = torch.sqrt(xl.var(-1, unbiased=False) + 1e-6)
        x_hat = (xl - xl.mean(-1, keepdim=True)) / sigma[:, None]
        e_c = model.embed - model.embed.mean(-1, keepdim=True)
        gain = torch.stack([
            (e_c - (model.embed @ x_hat[b] / d)[:, None] * x_hat[b]
             ).abs().sum(-1).max() / sigma[b]
            for b in range(xl.shape[0])])
    return logits, gain * drift, worst, maxima


def serve_tp_flops(bucket, batch=SERVE["batch"]):
    """FLOPs of one TP LM step over a [batch, bucket] batch (the MLP GEMMs
    at every position, the head at the last)."""
    g = SERVE_GPT
    return (2 * 2 * batch * bucket * g["hidden"] * g["mlp_dim"] *
            g["layers"] + 2 * batch * g["hidden"] * g["vocab"])


def serve_parity(device, steps):
    """(a): the fp32 TpLm on the card against the same model on the CPU
    (``axis=None``), 8 ragged prompts of 1-200 tokens in bucket 256; the
    int8 wire against fp32 within its bound, and against the int8 model
    on the CPU."""
    import torch
    from horovod_tpu_torch.serve.executor import make_tp_lm_step
    prompts = serve_prompts(SERVE["batch"], 1, SERVE["parity_max_len"],
                            SERVE_GPT["vocab"])
    tokens, lengths = serve_batch(prompts, SERVE["parity_bucket"],
                                  SERVE["batch"])
    card = {w: steps[w].logits(tokens, lengths).cpu() for w in steps}
    cpu = {}
    for wire in ("none", "int8"):
        step, _ = make_tp_lm_step(compression=wire, device="cpu",
                                  axis=None, **SERVE_GPT)
        cpu[wire] = step.logits(tokens, lengths)
        del step
    fp32_err = close("serve/fp32 card vs cpu", card["none"], cpu["none"],
                     1e-4, 1e-4)
    same_tokens = bool(torch.equal(card["none"].argmax(-1),
                                   cpu["none"].argmax(-1)))
    if not same_tokens:
        raise AssertionError("serve: the card's fp32 greedy tokens differ "
                             "from the CPU's")
    probe, bound, codec_ratio, maxima = serve_int8_probe(
        steps["int8"].model, tokens, lengths,
        wire_axis=steps["int8"].model.axis)
    probe_err = float((probe.cpu() - card["int8"]).abs().max())
    if probe_err > 1e-5:
        raise AssertionError(f"serve: the probe's int8 logits are "
                             f"{probe_err} from the step's")
    bound = bound.cpu()
    int8_row_err = (card["int8"] - card["none"]).abs().amax(-1)
    int8_err = float(int8_row_err.max())
    # the CPU's int8 logits: where a GEMM's summation order moves a value
    # across a rounding boundary of the codec, one int8 level in one
    # element, the later layers carry it on; such a row is held to the
    # codec's bound, the others to the fp32 tolerance
    cpu_row_err = (card["int8"] - cpu["int8"]).abs().amax(-1)
    int8_cpu_err = float(cpu_row_err.max())
    flipped = int(((card["int8"] - cpu["int8"]).abs() >
                   1e-4 + 1e-4 * cpu["int8"].abs()).any(-1).sum())
    if bool((int8_row_err > bound).any()) or \
            bool((cpu_row_err > bound).any()):
        raise AssertionError(f"serve: int8 logits off fp32 by "
                             f"{int8_row_err.tolist()}, off the CPU's "
                             f"int8 by {cpu_row_err.tolist()}, bound "
                             f"{bound.tolist()}")
    agree = float((card["int8"].argmax(-1) ==
                   card["none"].argmax(-1)).float().mean())
    return {"prompts_len": [len(p) for p in prompts],
            "bucket": SERVE["parity_bucket"],
            "fp32_card_vs_cpu": {"max_abs_err": fp32_err[0],
                                 "normwise_err": fp32_err[1],
                                 "tolerance_rtol_atol": [1e-4, 1e-4],
                                 "tokens_equal": same_tokens},
            "int8_vs_fp32": {"max_abs_err": int8_err,
                             "max_abs_err_by_row": int8_row_err.tolist(),
                             "bound_by_row": bound.tolist(),
                             "codec_worst_ratio": codec_ratio,
                             "codec_bit_equal_cpu": True,
                             "probe_vs_step_max_abs_err": probe_err,
                             "layer_abs_max": maxima,
                             "card_vs_cpu_int8_max_abs_err": int8_cpu_err,
                             "card_vs_cpu_int8_by_row":
                                 cpu_row_err.tolist(),
                             "card_vs_cpu_int8_rows_past_1e-4": flipped,
                             "token_agreement": agree},
            "logits_abs_max": float(card["none"].abs().max())}


def serve_step_times(steps):
    """(b): median ms of ``step_fn`` over 20 calls per bucket and wire (a
    full batch of 8 rows, host to host: tokens up, next tokens down),
    after a warm-up call; decode tokens/s at batch 8 and the fp32 bound of
    the step's GEMMs."""
    import numpy as np
    import torch
    rng = np.random.RandomState(1)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    for bucket in SERVE["buckets"]:
        tokens = rng.randint(0, SERVE_GPT["vocab"],
                             (SERVE["batch"], bucket)).astype(np.int32)
        lengths = rng.randint(1, bucket + 1,
                              SERVE["batch"]).astype(np.int32)
        entry = {"flops": serve_tp_flops(bucket),
                 "fp32_bound_ms": serve_tp_flops(bucket) /
                 PEAK_FLOPS["float32"] * 1e3}
        for wire, step in steps.items():
            step(tokens, lengths)  # warm-up: the bucket's first shapes
            ts = []
            for _ in range(SERVE["step_calls"]):
                t0 = time.perf_counter()
                step(tokens, lengths)
                ts.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(ts)
            entry[wire] = {"ms": ms, "min_ms": min(ts), "max_ms": max(ts),
                           "decode_tokens_per_s": SERVE["batch"] / ms * 1e3}
        out[str(bucket)] = entry
    return out, torch.cuda.max_memory_allocated()


def serve_http(step):
    """(c): 32 requests from 4 client threads to ServeFrontend over the
    int8 TP LM (prompts of 8-200 tokens from seed 0, 16 new tokens,
    deadline 30 s); each must come back ok with the tokens of its prompt
    decoded alone through the step. Before the load, token ids outside
    the vocabulary: the step refuses them on the host, and over HTTP they
    are answered 400, after which the load must still come back ok (an id
    that reached the card's embedding would leave the CUDA context
    unusable). Then drain with 8 requests in flight: /healthz must turn
    503 and every accepted request finish ok."""
    import threading
    import urllib.request
    from urllib import error as urlerror
    from horovod_tpu_torch.metrics import snapshot_histogram, snapshot_value
    from horovod_tpu_torch.metrics.registry import MetricsRegistry
    from horovod_tpu_torch.serve.batcher import (ContinuousBatcher,
                                                 InvalidRequest, bucket_for)
    from horovod_tpu_torch.serve.executor import ServingLoop
    from horovod_tpu_torch.serve.frontend import ServeFrontend, serving_stats
    from horovod_tpu_torch.serve.router import post_json
    prompts = serve_prompts(SERVE["http_requests"] + SERVE["drain_requests"],
                            SERVE["prompt_min"], SERVE["prompt_max"],
                            SERVE_GPT["vocab"])
    reg = MetricsRegistry()
    batcher = ContinuousBatcher(max_batch=SERVE["batch"], queue_depth=64,
                                default_deadline_ms=SERVE["deadline_ms"],
                                max_new_tokens_cap=SERVE["new_tokens"],
                                registry=reg, vocab=SERVE_GPT["vocab"])
    bad_ids = ([5, SERVE_GPT["vocab"]], [-1])
    step_refused = 0
    for ids in bad_ids:
        try:
            step(*serve_batch([ids], 32, SERVE["batch"]))
        except InvalidRequest:
            step_refused += 1
    buckets = sorted({bucket_for(len(p) + SERVE["new_tokens"],
                                 batcher.buckets) for p in prompts})
    for b in buckets:  # warm each bucket the load will use
        step(*serve_batch([[1] * (b // 2)], b, SERVE["batch"]))
    loop = ServingLoop(step, batcher, registry=reg).start()
    front = ServeFrontend(batcher=batcher, port=0, addr="127.0.0.1",
                          registry=reg).start()
    results, lock = {}, threading.Lock()

    def post_code(payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{front.port}/v1/generate",
            data=json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status
        except urlerror.HTTPError as e:
            return e.code

    def client(ids):
        for i in ids:
            t0 = time.perf_counter()
            out = post_json("127.0.0.1", front.port, "/v1/generate",
                            {"tokens": prompts[i],
                             "max_new_tokens": SERVE["new_tokens"],
                             "deadline_ms": SERVE["deadline_ms"],
                             "id": f"r{i}"}, timeout=120.0)
            with lock:
                results[i] = (out, time.perf_counter() - t0)

    n, k = SERVE["http_requests"], SERVE["http_clients"]
    try:
        bad_codes = [post_code({"tokens": ids, "max_new_tokens": 2})
                     for ids in bad_ids]
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(range(c, n, k),))
                   for c in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        snap = reg.snapshot()
        stats = serving_stats(snap)
        step_hist = snapshot_histogram(snap, "hvd_serve_step_seconds")
        # the drain: requests in flight, then /healthz must turn 503
        drain_ids = range(n, n + SERVE["drain_requests"])
        drainers = [threading.Thread(target=client, args=([i],))
                    for i in drain_ids]
        for t in drainers:
            t.start()
        deadline = time.monotonic() + 60.0
        while (snapshot_value(reg.snapshot(), "hvd_serve_admitted_total")
               or 0) < n + len(drainers) and time.monotonic() < deadline:
            time.sleep(0.001)  # until every drain request is accepted
        in_flight = len(drainers) - sum(1 for i in drain_ids
                                        if i in results)
        front.set_draining(True)
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{front.port}/healthz",
                                   timeout=10)
            health = 200
        except urlerror.HTTPError as e:
            health = e.code
        drained = loop.drain(timeout=120.0)
        for t in drainers:
            t.join()
    finally:
        loop.stop()
        front.stop()
    if step_refused != len(bad_ids) or bad_codes != [400] * len(bad_ids):
        raise AssertionError(f"serve/http: ids outside the vocabulary: "
                             f"{step_refused} refused by the step, HTTP "
                             f"{bad_codes}")
    bad = {i: r[0] for i, r in results.items() if r[0].get("status") != "ok"}
    if bad or len(results) != n + len(drainers):
        raise AssertionError(f"serve/http: requests not ok: {bad}")
    if health != 503 or not drained:
        raise AssertionError(f"serve/http: drain: healthz {health}, "
                             f"drained {drained}")
    final = serving_stats(reg.snapshot())
    if final["requests_ok"] != n + len(drainers) or \
            final["requests_failed"] or final["requests_expired"]:
        raise AssertionError(f"serve/http: lost requests: {final}")
    mismatched = []
    for i, p in enumerate(prompts):
        bucket = bucket_for(len(p) + SERVE["new_tokens"], batcher.buckets)
        alone = serve_greedy(step, p, SERVE["new_tokens"], bucket,
                             SERVE["batch"])
        if results[i][0]["tokens"] != alone:
            mismatched.append(i)
    if mismatched:
        raise AssertionError(f"serve/http: requests {mismatched} differ "
                             "from their prompts decoded alone")
    lat = sorted(r[1] * 1e3 for i, r in results.items() if i < n)
    gen = sum(len(r[0]["tokens"]) for i, r in results.items() if i < n)
    busy = step_hist["sum"] if step_hist else 0.0
    return {"requests": n, "clients": k, "new_tokens": SERVE["new_tokens"],
            "buckets": buckets, "wall_s": wall,
            "latency_p50_ms": lat[len(lat) // 2],
            "latency_p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "latency_max_ms": lat[-1],
            "decode_steps": stats["decode_steps"],
            "decode_steps_per_s": stats["decode_steps"] / wall,
            "generated_tokens_per_s": gen / wall,
            "batch_occupancy_mean": stats["batch_occupancy_mean"],
            "decode_thread_busy_s": busy,
            "decode_thread_idle_share": 1.0 - busy / wall,
            "server_latency_p50_ms": stats["latency_p50_ms"],
            "server_latency_p99_ms": stats["latency_p99_ms"],
            "tokens_equal_alone": True,
            "ids_outside_vocab": {"step_refused": step_refused,
                                  "http_codes": bad_codes,
                                  "then_requests_ok": n},
            "drain": {"requests": len(drainers),
                      "in_flight_at_drain": in_flight,
                      "healthz": health, "drained": drained,
                      "requests_ok": final["requests_ok"]}}


def serve_fastpath(device):
    """(d): the recurrent LM (hidden 192, vocab 256) on the card behind
    PagedKVCache(16, 256) with speculative decode (k 4) over the
    shared-prefix trace (prefix 160, tail 16, 16 new tokens): cached +
    speculative greedy tokens equal recompute's on the trace's first 16
    prompts; accept rate, ms per advance at batch 8, goodput at one
    offered load for both stacks, and the pool balanced at the end."""
    import numpy as np
    import torch
    from horovod_tpu_torch.metrics import snapshot_value
    from horovod_tpu_torch.metrics.registry import MetricsRegistry
    from horovod_tpu_torch.serve import loadgen
    from horovod_tpu_torch.serve.batcher import (AdmissionRejected,
                                                 ContinuousBatcher)
    from horovod_tpu_torch.serve.executor import (ServingLoop,
                                                  make_rnn_lm_step)
    from horovod_tpu_torch.serve.kv_cache import PagedKVCache
    f = SERVE_FAST
    trace = loadgen.shared_prefix_trace(
        seed=0, requests=256, tenants=f["tenants"],
        prefix_len=f["prefix_len"], tail_len=f["tail_len"],
        max_new_tokens=f["new_tokens"], vocab=f["vocab"])
    step_fn, cached, draft, info = make_rnn_lm_step(
        hidden=f["hidden"], vocab=f["vocab"], device=device)

    def build(fast):
        reg = MetricsRegistry()
        cache = PagedKVCache(block_tokens=f["block_tokens"],
                             pool_blocks=f["pool_blocks"],
                             registry=reg) if fast else None
        batcher = ContinuousBatcher(max_batch=8, queue_depth=32,
                                    default_deadline_ms=f["deadline_ms"],
                                    max_len=256, registry=reg, cache=cache)
        loop = ServingLoop(step_fn, batcher, registry=reg,
                           cached_step=cached if fast else None,
                           draft_step=draft if fast else None,
                           spec_k=f["spec_k"]).start()
        return reg, batcher, loop

    def decode(fast):
        reg, batcher, loop = build(fast)
        try:
            reqs = [batcher.submit(t["tokens"],
                                   max_new_tokens=t["max_new_tokens"],
                                   deadline_ms=120e3)
                    for t in trace[:f["pin_prompts"]]]
            for r in reqs:
                r.wait(180.0)
        finally:
            loop.drain(timeout=60.0)
            loop.stop()
        if any(r.status != "ok" for r in reqs):
            raise AssertionError(f"serve/fastpath: {[r.status for r in reqs]}")
        return [r.generated for r in reqs], reg, batcher

    plain, _, _ = decode(False)
    fast, reg, batcher = decode(True)
    if fast != plain:
        raise AssertionError("serve/fastpath: cached + speculative tokens "
                             "differ from recompute")
    snap = reg.snapshot()
    proposed = snapshot_value(snap, "hvd_serve_spec_proposed_total") or 0
    accepted = snapshot_value(snap, "hvd_serve_spec_accepted_total") or 0

    # ms per advance at batch 8: one steady decode position and one
    # verify of k drafted tokens + the bonus, from prompt checkpoints
    rows = trace[:8]
    width = max(len(t["tokens"]) for t in rows) + f["spec_k"] + 1
    tokens = np.zeros((8, width), np.int32)
    for i, t in enumerate(rows):
        tokens[i, :len(t["tokens"])] = t["tokens"]
    lens = np.array([len(t["tokens"]) for t in rows], np.int64)
    _, states = cached.advance(tokens, lens, cached.init_state(8),
                               np.zeros(8, np.int64))
    state = states[np.arange(8), lens - 1]
    advance_ms = {}
    for name, a in (("decode_1", 1), ("verify_k1", f["spec_k"] + 1)):
        ts = []
        for _ in range(5 + 20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cached.advance(tokens, lens + a, state, lens)
            ts.append((time.perf_counter() - t0) * 1e3)
        advance_ms[name] = statistics.median(ts[5:])

    def window(fast):
        reg, batcher, loop = build(fast)

        def submit(payload):
            try:
                req = batcher.submit(payload["tokens"],
                                     max_new_tokens=payload[
                                         "max_new_tokens"])
            except AdmissionRejected:
                return {"status": "rejected"}
            req.wait(f["deadline_ms"] / 1e3 + 5.0)
            return req.result()
        try:
            for t in range(f["tenants"]):  # publish the shared prefixes
                submit(dict(trace[t]))
            out = loadgen.run_load(submit, f["offered_qps"], f["window_s"],
                                   loadgen.trace_payload_fn(trace))
        finally:
            loop.drain(timeout=60.0)
            loop.stop()
        if fast:
            out["pool_balanced"] = batcher.cache.balanced()
            snap = reg.snapshot()
            out["prefill_tokens_saved"] = snapshot_value(
                snap, "hvd_serve_cache_prefill_tokens_saved_total")
        return out

    fast_w, plain_w = window(True), window(False)
    if not (batcher.cache.balanced() and fast_w["pool_balanced"]):
        raise AssertionError("serve/fastpath: cache pool not balanced")
    return {"model": info, "trace": {k: f[k] for k in (
                "prefix_len", "tail_len", "new_tokens", "tenants")},
            "cache": {"block_tokens": f["block_tokens"],
                      "pool_blocks": f["pool_blocks"]},
            "spec_k": f["spec_k"], "pin_prompts": f["pin_prompts"],
            "tokens_equal_recompute": True,
            "spec_proposed": proposed, "spec_accepted": accepted,
            "accept_rate": accepted / proposed if proposed else None,
            "advance_ms_batch8": advance_ms,
            "offered_qps": f["offered_qps"], "deadline_ms": f["deadline_ms"],
            "goodput_fast": fast_w, "goodput_recompute": plain_w,
            "cache_balanced": True}


def serve_phase(device, card):
    """The serve phase at world 1 on NCCL: parts (a)-(d)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serve.executor import (activation_wire_report,
                                                  make_tp_lm_step)
    tf32 = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    if tf32 != {"allow_tf32": False, "float32_matmul_precision": "highest"}:
        raise AssertionError(f"serve: GEMMs not in full fp32: {tf32}")
    # what earlier phases still hold: the step times' peak counts it too
    held = torch.cuda.memory_allocated()
    fa.reset_launch_counts()
    hvd.init()
    try:
        t0 = time.perf_counter()
        steps = {w: make_tp_lm_step(compression=w, device=device,
                                    **SERVE_GPT)[0]
                 for w in ("none", "int8")}
        build_s = time.perf_counter() - t0
        params = sum(p.numel() for p in steps["none"].model.parameters())
        parity = serve_parity(device, steps)
        times, peak = serve_step_times(steps)
        http = serve_http(steps["int8"])
        del steps
        torch.cuda.empty_cache()
        fastpath = serve_fastpath(device)
    finally:
        hvd.shutdown()
    counts = dict(fa.launch_counts())
    if any(counts.values()):
        raise AssertionError(f"serve: flash kernels launched: {counts}")
    return counts, {"phase": "serve", "nvidia_smi": card, "backend": "nccl",
                    "world_size": 1, "tf32": tf32,
                    "model": dict(SERVE_GPT, params=params,
                                  build_s=build_s),
                    "wire": activation_wire_report(SERVE_GPT["hidden"],
                                                   SERVE_GPT["layers"], 1),
                    "parity": parity, "step_ms": times,
                    "peak_mem_bytes": peak,
                    "mem_held_at_phase_start_bytes": held, "http": http,
                    "fastpath": fastpath, "flash_launches": counts}


# ---------------------------------------------------------------------------
# the launch phase: the port's launcher and elastic driver on the card

# GPT-2 small as the training scripts take it: the train phase's model,
# batch, optimizer and gradient wire (gpt_train) and the elastic phase's
# per-step batches (elastic_train), both from seed 0
GPT2_SMALL_FLAGS = ["--vocab", "50257", "--layers", "12", "--hidden", "768",
                    "--heads", "12", "--seq-len", str(MAIN["t"]),
                    "--batch-per-replica", str(MAIN["b"]), "--dtype",
                    "bfloat16", "--seed", "0"]
LAUNCH = dict(elastic_steps=8, commit_every=2, fault_at=4, requests=8,
              new_tokens=16, timeout_s=300, layers=12, device="cuda:0",
              # the replicated leg: steps enough to outlast the election
              # (1.5 leases of silence, lease 2 s; 6.2-6.5 s with a split
              # vote) and the respawned replica's resync (7.8-8.5 s after
              # the kill) by ~10 s; the KV leader dies after step 2's commit
              replicated_steps=250, kill_after=2, replicas=3,
              # the examples leg
              lc_seq=32768, resnet_iters=5, mnist_steps=20)
ROOT = os.path.dirname(os.path.abspath(__file__))


class Launched:
    """``python -m horovod_tpu_torch.runner.launch <args>`` as a child
    process; its output lines kept with their arrival times (and in
    ``log_path``)."""

    def __init__(self, args, env=None, log_path=None):
        import threading
        self.t0 = time.time()
        full_env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
             *args], cwd=ROOT, env=full_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines = []
        self._log = open(log_path, "w") if log_path else None
        self._pump = threading.Thread(target=self._read, daemon=True)
        self._pump.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append((time.time(), line))
            if self._log is not None:
                self._log.write(line)
                self._log.flush()

    def records(self):
        """The JSON lines the workers printed."""
        out = []
        for _, line in self.lines:
            _, sep, body = line.partition("<stdout>:")
            if sep and body.startswith("{"):
                out.append(json.loads(body))
        return out

    def finish(self, timeout):
        """The launcher's exit code; on a timeout it is interrupted (the
        launcher stops its workers) and, failing that, killed."""
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.send_signal(2)  # SIGINT: the launcher cleans up
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            raise AssertionError(
                f"launch: no exit within {timeout} s:\n" +
                "".join(line for _, line in self.lines[-40:]))
        finally:
            self._pump.join(timeout=10)
            if self._log is not None:
                self._log.close()


def _check_rc(name, rc, job):
    if rc != 0:
        raise AssertionError(
            f"launch/{name}: launcher exited {rc}:\n" +
            "".join(line for _, line in job.lines[-60:]))


def _log_path(out_dir, name):
    return os.path.join(out_dir, f"launch_{name}.log") if out_dir else None


def launch_static(train_line, out_dir):
    """GPT-2 small, 5 steps, through the launcher at -np 1: the train
    phase's losses (the same model, batch and optimizer from seed 0) and
    12 launches of each kernel a step."""
    job = Launched(["-np", "1", "-H", "localhost:1", "--", sys.executable,
                    "-m", "horovod_tpu_torch.examples.gpt_train",
                    "--steps", str(STEPS), *GPT2_SMALL_FLAGS],
                   log_path=_log_path(out_dir, "static"))
    rc = job.finish(LAUNCH["timeout_s"])
    _check_rc("static", rc, job)
    recs = [r for r in job.records() if "loss" in r]
    want = train_line["losses"]
    losses = [r["loss"] for r in recs]
    if len(losses) != STEPS:
        raise AssertionError(f"launch/static: {len(losses)} steps")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    if not rel <= 1e-5:
        raise AssertionError(f"launch/static: losses {losses} against the "
                             f"train phase's {want} (rel {rel})")
    counts = recs[-1]["flash_launches"]
    if counts != {k: LAUNCH["layers"] * STEPS for k in counts}:
        raise AssertionError(f"launch/static: launches {counts}")
    steady = [r["step_ms"] for r in recs[1:]]
    train_steady = train_line["step_ms"][1:]
    return counts, {
        "leg": "static", "rc": rc, "losses": losses,
        "train_phase_losses": want, "bit_equal": losses == want,
        "max_rel_err": rel, "step_ms": [r["step_ms"] for r in recs],
        "steady_step_ms": statistics.mean(steady),
        "train_phase_steady_step_ms": [min(train_steady),
                                       max(train_steady)],
        "within_train_spread": min(train_steady) <= statistics.median(
            steady) <= max(train_steady),
        "launch_to_first_step_s": recs[0]["wall"] - job.t0,
        "total_s": job.lines[-1][0] - job.t0 if job.lines else None,
        "device": recs[0]["device"], "launches": counts}


def launch_elastic(out_dir):
    """GPT-2 small under elastic.run through the launcher's elastic
    driver at min = max = 1: the worker SIGKILLs itself once after the
    commit of step 4; the driver reaps it (one failure strike, no
    blacklist) and respawns the slot at generation 1 on the same card,
    which trains the job to its end (a world of one keeps no commit
    outside the dead process: it starts over, and its first four losses
    must equal the first attempt's). The job runs with a durable KV, a
    journal and a flight directory in one directory, over which the
    port's hvd-doctor must name the kill; the respawn's end dump goes
    apart, for the analyzer's CLI."""
    import tempfile
    from horovod_tpu_torch.common import journal
    tmp = tempfile.mkdtemp(prefix="hvd_launch_elastic_")
    script = os.path.join(tmp, "discover.sh")
    with open(script, "w") as f:
        f.write("#!/bin/sh\necho localhost:1\n")
    os.chmod(script, 0o755)
    job_dir, end_dir = os.path.join(tmp, "job"), os.path.join(tmp, "end")
    jdir, marker = os.path.join(job_dir, "journal"), os.path.join(
        tmp, "fault.json")
    job = Launched(["--min-np", "1", "--max-np", "1",
                    "--host-discovery-script", script, "--verbose", "--",
                    sys.executable, "-m",
                    "horovod_tpu_torch.examples.elastic_train", "--model",
                    "gpt", *GPT2_SMALL_FLAGS, "--steps",
                    str(LAUNCH["elastic_steps"]), "--commit-every",
                    str(LAUNCH["commit_every"]), "--fault-at",
                    str(LAUNCH["fault_at"]), "--fault-rank", "0",
                    "--fault-marker", marker, "--flight-dump", end_dir],
                   env={"HOROVOD_JOURNAL_DIR": jdir,
                        "HOROVOD_KV_DIR": os.path.join(job_dir, "kv"),
                        "HOROVOD_FLIGHT_DIR": os.path.join(job_dir,
                                                           "flight")},
                   log_path=_log_path(out_dir, "elastic"))
    rc = job.finish(LAUNCH["timeout_s"])
    _check_rc("elastic", rc, job)
    with open(marker) as f:
        fault = json.load(f)
    events = [e for e in journal.load_events(jdir)
              if e.get("component") == "driver"]
    exits = [dict(e.get("detail", {}), t_wall=e["t_wall"]) for e in events
             if e["event"] == "worker_exit"]
    failures = [e for e in exits if e["reason"] == "failure"]
    spawns = [e for e in events if e["event"] == "worker_spawn"]
    if len(failures) != 1 or failures[0]["exit_code"] != -9 or \
            len(spawns) != 2 or \
            any(e["event"] == "host_blacklist" for e in events):
        raise AssertionError(f"launch/elastic: driver records {events}")
    recs = [r for r in job.records() if "loss" in r]
    first = [r for r in recs if r["pid"] == fault["pid"]]
    again = [r for r in recs if r["pid"] != fault["pid"]]
    n = LAUNCH["elastic_steps"]
    if [r["step"] for r in first] != list(range(1, LAUNCH["fault_at"] + 1)) \
            or [r["step"] for r in again] != list(range(1, n + 1)) or \
            {r["generation"] for r in again} != {1} or \
            {r["device"] for r in recs} != {LAUNCH["device"]}:
        raise AssertionError(f"launch/elastic: steps {recs}")
    redo = [r["loss"] for r in again[:len(first)]]
    if redo != [r["loss"] for r in first]:
        raise AssertionError(f"launch/elastic: redone losses {redo} differ "
                             f"from {[r['loss'] for r in first]}")
    counts = {k: first[-1]["flash_launches"][k] +
              again[-1]["flash_launches"][k] for k in NAMES}
    want = LAUNCH["layers"] * (LAUNCH["fault_at"] + n)
    if counts != {k: want for k in counts}:
        raise AssertionError(f"launch/elastic: launches {counts}")
    respawn = spawns[1]
    doctor, flight_cli = launch_postmortem(job_dir, end_dir)
    return counts, {
        "leg": "elastic", "rc": rc,
        "doctor": doctor, "flight_cli": flight_cli,
        "detection_s": failures[0]["t_wall"] - fault["wall"],
        "respawn_to_first_step_s": again[0]["wall"] - respawn["t_wall"],
        "kill_to_first_step_s": again[0]["wall"] - fault["wall"],
        "steps_redone": first[-1]["step"] - (again[0]["step"] - 1),
        "redone_losses_bit_equal": True,
        "losses_first_attempt": [r["loss"] for r in first],
        "losses_after_respawn": [r["loss"] for r in again],
        "respawn_generation": respawn.get("generation"),
        "driver_records": [
            {k: e.get(k) for k in ("event", "generation", "local_rank")}
            | e.get("detail", {}) for e in events],
        "artifacts": {"job": job_dir, "end": end_dir},
        "launches": counts}


def _tool(args, timeout=120):
    """``python -m <args>`` from the checkout; (exit code, stdout,
    stderr)."""
    out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    return out.returncode, out.stdout, out.stderr


def launch_postmortem(job_dir, end_dir):
    """The port's hvd-doctor over the elastic leg's directory (journal,
    KV WAL, flight dumps): one incident, the SIGKILLed worker; and the
    flight analyzer's CLI over the respawn's end dump."""
    rc, text, err = _tool(["horovod_tpu_torch.obs.doctor", job_dir,
                           "--json"])
    if rc != 0:
        raise AssertionError(f"launch/elastic: doctor exited {rc}: {err}")
    verdict = json.loads(text)
    incidents = verdict["incidents"]
    if verdict["incident_count"] != 1 or \
            incidents[0]["cause"] != "dead_rank" or \
            "-9" not in incidents[0]["root_cause"]:
        raise AssertionError(f"launch/elastic: doctor verdict {verdict}")
    rc, text, err = _tool(["horovod_tpu_torch.profiler.flight", end_dir,
                           "--trace", os.path.join(end_dir, "trace.json")])
    if rc != 0 or "flight dumps: ranks [0] of 1" not in text:
        raise AssertionError(f"launch/elastic: flight CLI {rc}: {text}"
                             f"{err}")
    return ({"incident_count": 1, "top_cause": verdict["top_cause"],
             "root_cause": incidents[0]["root_cause"]},
            text.strip().splitlines())


def launch_serve(device, out_dir):
    """One ``python -m horovod_tpu_torch.serve.worker`` (the TP LM at
    GPT-2 small's widths on the int8 wire) spawned by the driver in its
    durable mode; a RequestRouter reading the driver's ``serve_targets``
    sends it 8 requests at once, each equal to its prompt decoded alone
    through the same model in this process; ``serve_stop`` ends the job."""
    import socket
    import tempfile
    import threading
    from horovod_tpu_torch.common import kv_keys
    from horovod_tpu_torch.metrics.registry import MetricsRegistry
    from horovod_tpu_torch.runner.http_kv import KVClient
    from horovod_tpu_torch.serve.batcher import ContinuousBatcher, bucket_for
    from horovod_tpu_torch.serve.executor import make_tp_lm_step
    from horovod_tpu_torch.serve.router import RequestRouter, post_json
    tmp = tempfile.mkdtemp(prefix="hvd_launch_serve_")
    script = os.path.join(tmp, "discover.sh")
    with open(script, "w") as f:
        f.write("#!/bin/sh\necho localhost:1\n")
    os.chmod(script, 0o755)
    kv_dir = os.path.join(tmp, "kv")
    from horovod_tpu_torch.serve.worker import TP_WIDTHS
    # the worker's preset is the model decoded alone below (seed 0 on
    # both sides: make_tp_lm_step's default)
    assert dict(TP_WIDTHS["tp-gpt2-small"], seed=0) == SERVE_GPT, TP_WIDTHS
    with socket.socket() as sock:  # the worker's metrics endpoint
        sock.bind(("127.0.0.1", 0))
        metrics_port = sock.getsockname()[1]
    job = Launched(["--min-np", "1", "--max-np", "1",
                    "--host-discovery-script", script, "--verbose", "--",
                    sys.executable, "-m", "horovod_tpu_torch.serve.worker",
                    "--model", "tp-gpt2-small", "--compression", "int8",
                    "--port", "0"],
                   env={"HOROVOD_KV_DIR": kv_dir,
                        "HOROVOD_METRICS_PORT": str(metrics_port)},
                   log_path=_log_path(out_dir, "serve"))
    results, t_listed = {}, None
    try:
        args_path = os.path.join(kv_dir, "driver_args.json")
        deadline = time.monotonic() + 60
        while not os.path.exists(args_path):
            if time.monotonic() > deadline or job.proc.poll() is not None:
                raise AssertionError("launch/serve: no driver started")
            time.sleep(0.1)
        with open(args_path) as f:
            kv = KVClient("127.0.0.1", json.load(f)["kv_port"])
        router = RequestRouter(retry_limit=3, registry=MetricsRegistry())
        deadline = time.monotonic() + 180
        while not [w for w in router.workers() if w["state"] == "up"]:
            if time.monotonic() > deadline or job.proc.poll() is not None:
                raise AssertionError("launch/serve: serve_targets never "
                                     "listed the worker")
            time.sleep(0.25)
            router.refresh_from_kv(lambda k: kv.get_json(k, timeout=1.0))
        t_listed = time.time()
        # hvd-top's serving view lists the worker while it serves
        top_rc, top_text, top_err = _tool([
            "horovod_tpu_torch.obs.top", "--once", "--serving", "--targets",
            f"127.0.0.1:{metrics_port}"])
        top_rows = [ln for ln in top_text.splitlines()
                    if ln.split()[:1] == ["0"]]
        if top_rc != 0 or len(top_rows) != 1:
            raise AssertionError(f"launch/serve: hvd-top {top_rc}: "
                                 f"{top_text}{top_err}")
        prompts = serve_prompts(LAUNCH["requests"], SERVE["prompt_min"],
                                SERVE["prompt_max"], SERVE_GPT["vocab"],
                                seed=1)

        def send(worker, payload):
            return post_json(worker.addr, worker.port, "/v1/generate",
                             payload, timeout=180.0)

        def client(i):
            results[i] = router.submit(
                f"l{i}", {"tokens": prompts[i],
                          "max_new_tokens": LAUNCH["new_tokens"],
                          "deadline_ms": SERVE["deadline_ms"],
                          "id": f"l{i}"}, send)

        t0 = time.time()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        wall = time.time() - t0
        # hvd-lint: disable=HVL008 - the user's stop signal, a KVClient write
        kv.put_json(kv_keys.serve_stop(), {"ts": time.time()})
    finally:
        rc = job.finish(LAUNCH["timeout_s"])
    _check_rc("serve", rc, job)
    bad = {i: r for i, r in results.items() if r.get("status") != "ok"}
    if bad or len(results) != len(prompts):
        raise AssertionError(f"launch/serve: requests not ok: {bad}")
    step, _ = make_tp_lm_step(compression="int8", device=device, axis=None,
                              **SERVE_GPT)
    buckets = ContinuousBatcher().buckets
    mismatched = [
        i for i, p in enumerate(prompts)
        if results[i]["tokens"] != serve_greedy(
            step, p, LAUNCH["new_tokens"],
            bucket_for(len(p) + LAUNCH["new_tokens"], buckets),
            SERVE["batch"])]
    del step
    if mismatched:
        raise AssertionError(f"launch/serve: requests {mismatched} differ "
                             "from their prompts decoded alone")
    return {"leg": "serve", "rc": rc, "requests": len(results),
            "all_ok": True, "tokens_equal_alone": True,
            "launch_to_serve_targets_s": t_listed - job.t0,
            "top_serving_row": top_rows[0],
            "requests_wall_s": wall,
            "prompt_lengths": [len(p) for p in prompts],
            "artifacts": {"kv": kv_dir}}


def run_leg_train(steps):
    """GPT-2 small as phase train (bf16 compute, seq 1024, batch 8, AdamW,
    the bf16 wire, weights and batch from seed 0) for ``steps`` steps, in
    the process ``horovod_tpu_torch.run`` starts: it goes there by
    reference (this script's path and the name), so it stays at module
    level. On the card of its local rank."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.gpt import GptSmall, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import dp
    hvd.init()
    try:
        model = GptSmall(dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(0))
        tokens = torch.randint(0, 50257, (MAIN["b"] * hvd.size(), MAIN["t"]),
                               generator=torch.Generator().manual_seed(0))
        batch = dp.shard_batch(tokens).to(hvd.device())
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        step = dp.make_train_step(model, lm_loss, opt,
                                  compression=hvd.Compression.bf16)
        fa.reset_launch_counts()
        losses, step_ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(step(batch).loss.item())  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return {"losses": losses, "step_ms": step_ms,
                "launches": fa.launch_counts(), "rank": hvd.rank(),
                "size": hvd.size(), "device": str(hvd.device())}
    finally:
        hvd.shutdown()


def _same_losses(leg, losses, want):
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    if len(losses) < len(want) or not rel <= 1e-5:
        raise AssertionError(f"launch/{leg}: losses {losses} against the "
                             f"train phase's {want} (rel {rel})")
    return rel


def launch_run(train_line):
    """``horovod_tpu_torch.run(run_leg_train, np=1)``: the train phase's
    losses within rel 1e-5, 12 launches of each kernel a step, on
    cuda:0; the seconds from the call to its return."""
    import horovod_tpu_torch as hvd
    t0 = time.perf_counter()
    results = hvd.run(run_leg_train, args=(STEPS,), np=1)
    seconds = time.perf_counter() - t0
    (res,) = results
    want = train_line["losses"]
    rel = _same_losses("run", res["losses"], want)
    counts = res["launches"]
    if counts != {k: LAUNCH["layers"] * STEPS for k in NAMES} or \
            res["device"] != LAUNCH["device"] or res["size"] != 1:
        raise AssertionError(f"launch/run: {res}")
    return counts, {
        "leg": "run", "call_to_return_s": seconds, "losses": res["losses"],
        "train_phase_losses": want, "bit_equal": res["losses"] == want,
        "max_rel_err": rel, "step_ms": res["step_ms"],
        "device": res["device"], "launches": counts}


def _replica_endpoints(kv_dir, timeout=60.0):
    """The replica fleet's endpoint list and each replica's pid, from the
    command lines of the ``replica_kv`` processes whose ``--dir`` lies
    under ``kv_dir``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        procs = {}
        found = subprocess.run(
            ["pgrep", "-f", "horovod_tpu_torch.runner.replica_kv"],
            capture_output=True, text=True).stdout.split()
        for pid in found:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = f.read().decode().split("\x00")
            except OSError:
                continue
            if "--dir" in argv and \
                    argv[argv.index("--dir") + 1].startswith(kv_dir):
                procs[int(argv[argv.index("--id") + 1])] = (
                    int(pid), argv[argv.index("--endpoints") + 1].split(","))
        if len(procs) == LAUNCH["replicas"]:
            return procs[0][1], {i: p for i, (p, _) in procs.items()}
        time.sleep(0.2)
    raise AssertionError(f"launch/replicated: replicas {procs}")


def _kill_kv_leader(kv_dir, t_step):
    """After the commit of step ``kill_after``: an acknowledged write
    through the failover client (``KVClient`` over the replica list, as the
    driver's handle holds it), then SIGKILL of the leaseholder's process.
    Returns what the leg checks: the new leader (a follower, a higher
    epoch) and the seconds to it, the key read back through it, and the
    replicas' store hashes once all three answer (the dead one respawned
    by the supervisor and resynced)."""
    import signal
    from horovod_tpu_torch.common import kv_keys
    from horovod_tpu_torch.runner.http_kv import KVClient
    from horovod_tpu_torch.runner.replica_kv import (replica_statuses,
                                                      wait_for_leader)
    eps, pids = _replica_endpoints(kv_dir)
    host, _, port = eps[0].rpartition(":")
    client = KVClient(host, int(port), endpoints=eps)
    key, value = kv_keys.soak_event(1), {"acked_after_step": t_step}
    # hvd-lint: disable=HVL008 - a client write to the replica fleet
    client.put_json(key, value, deadline=20.0)
    old = wait_for_leader(eps, timeout=10.0)
    t_kill = time.time()
    os.kill(pids[int(old["id"])], signal.SIGKILL)
    new = None
    while time.time() - t_kill < 60:
        st = wait_for_leader(eps, timeout=1.0)
        if st is not None and int(st["id"]) != int(old["id"]):
            new = st
            break
    if new is None or not new["epoch"] > old["epoch"]:
        raise AssertionError(f"launch/replicated: no follower won a higher "
                             f"epoch than {old} ({new})")
    t_leader = time.time()
    read_back = client.get_json_leader(key)
    hashes, t_healed = {}, None
    while time.time() - t_kill < 120:
        sts = replica_statuses(eps)
        hashes = {ep: st and st["store_hash"] for ep, st in sts.items()}
        if all(hashes.values()) and len(set(hashes.values())) == 1:
            t_healed = time.time()
            break
        time.sleep(0.2)
    return {"killed_replica": int(old["id"]), "old_epoch": old["epoch"],
            "new_leader": int(new["id"]), "new_epoch": new["epoch"],
            "kill_wall": t_kill, "kill_to_new_leader_s": t_leader - t_kill,
            "kill_to_healed_s": t_healed - t_kill if t_healed else None,
            "acked_key": key, "acked_value": value, "read_back": read_back,
            "store_hashes": hashes}


def launch_replicated(train_line, out_dir):
    """GPT-2 small (elastic_train --fixed-batch --compression bf16: the
    train phase's model, batch and wire) under elastic.run through the
    supervised elastic launcher at min = max = 1, with HOROVOD_KV_DIR,
    HOROVOD_DRIVER_SUPERVISE and HOROVOD_KV_REPLICAS=3: after step 2's
    commit the KV leaseholder is SIGKILLed (:func:`_kill_kv_leader`). A
    follower must win at a higher epoch, the supervisor respawn the dead
    replica (``kv_replica_respawn`` in the journal), the acknowledged key
    read back from the new leader, the three store hashes agree once
    healed, and the job exit 0 with its first losses the train phase's
    (rel 1e-5) and 12 launches of each kernel a step. The seconds from the
    kill to the new leader, and the largest gap between steps across the
    kill against the median step."""
    import tempfile
    import threading
    from horovod_tpu_torch.common import journal
    tmp = tempfile.mkdtemp(prefix="hvd_launch_replicated_")
    script = os.path.join(tmp, "discover.sh")
    with open(script, "w") as f:
        f.write("#!/bin/sh\necho localhost:1\n")
    os.chmod(script, 0o755)
    kv_dir, jdir = os.path.join(tmp, "kv"), os.path.join(tmp, "journal")
    n = LAUNCH["replicated_steps"]
    job = Launched(["--min-np", "1", "--max-np", "1",
                    "--host-discovery-script", script, "--verbose", "--",
                    sys.executable, "-m",
                    "horovod_tpu_torch.examples.elastic_train", "--model",
                    "gpt", *GPT2_SMALL_FLAGS, "--fixed-batch",
                    "--compression", "bf16", "--steps", str(n),
                    "--commit-every", str(LAUNCH["commit_every"])],
                   env={"HOROVOD_KV_DIR": kv_dir,
                        "HOROVOD_DRIVER_SUPERVISE": "1",
                        "HOROVOD_KV_REPLICAS": str(LAUNCH["replicas"]),
                        "HOROVOD_JOURNAL_DIR": jdir},
                   log_path=_log_path(out_dir, "replicated"))
    kill = {}
    try:
        deadline = time.monotonic() + LAUNCH["timeout_s"]
        while not [r for r in job.records() if r.get("committed") and
                   r.get("step", 0) >= LAUNCH["kill_after"]]:
            if time.monotonic() > deadline or job.proc.poll() is not None:
                raise AssertionError(
                    "launch/replicated: no commit of step "
                    f"{LAUNCH['kill_after']}:\n" +
                    "".join(line for _, line in job.lines[-40:]))
            time.sleep(0.05)
        def act():
            try:
                kill.update(_kill_kv_leader(kv_dir, LAUNCH["kill_after"]))
            except Exception as e:  # noqa: BLE001 - reported below
                kill["error"] = repr(e)

        # off the output's reader, so the workers never wait on the pipe
        worker = threading.Thread(target=act, daemon=True)
        worker.start()
        worker.join(timeout=200)
    finally:
        rc = job.finish(LAUNCH["timeout_s"])
    _check_rc("replicated", rc, job)
    if not kill or "error" in kill or \
            kill["read_back"] != kill["acked_value"] or \
            kill["kill_to_healed_s"] is None:
        raise AssertionError(f"launch/replicated: {kill}")
    respawns = [e for e in journal.load_events(jdir)
                if e.get("component") == "supervisor" and
                e["event"] == "kv_replica_respawn"]
    if [e["detail"]["replica"] for e in respawns] != \
            [kill["killed_replica"]]:
        raise AssertionError(f"launch/replicated: respawns {respawns}")
    recs = [r for r in job.records() if "loss" in r]
    if [r["step"] for r in recs] != list(range(1, n + 1)) or \
            len({r["pid"] for r in recs}) != 1 or \
            {r["device"] for r in recs} != {LAUNCH["device"]} or \
            not all(math.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"launch/replicated: steps {recs[:8]}...")
    losses = [r["loss"] for r in recs]
    want = train_line["losses"]
    rel = _same_losses("replicated", losses[:len(want)], want)
    counts = recs[-1]["flash_launches"]
    if counts != {k: LAUNCH["layers"] * n for k in NAMES}:
        raise AssertionError(f"launch/replicated: launches {counts}")
    walls = [r["wall"] for r in recs]
    gaps = [b - a for a, b in zip(walls, walls[1:])]
    t_kill = kill["kill_wall"]
    across = [b - a for a, b in zip(walls, walls[1:])
              if b >= t_kill - 1.0 and a <= t_kill + kill[
                  "kill_to_healed_s"] + 1.0]
    return counts, {
        "leg": "replicated", "rc": rc, "steps": n,
        "losses_first": losses[:len(want)], "train_phase_losses": want,
        "bit_equal": losses[:len(want)] == want, "max_rel_err": rel,
        **{k: v for k, v in kill.items() if k != "kill_wall"},
        "respawns": [e["detail"] for e in respawns],
        "max_step_gap_across_kill_s": max(across) if across else None,
        "median_step_gap_s": statistics.median(gaps),
        "median_step_ms": statistics.median(r["step_ms"] for r in recs),
        "steps_during_election": sum(
            1 for w in walls
            if t_kill <= w <= t_kill + kill["kill_to_new_leader_s"]),
        "artifacts": {"kv": kv_dir, "journal": jdir},
        "launches": counts}


def _example(name, args, timeout=300):
    """``python -m horovod_tpu_torch.examples.<name> <args>`` on cuda:0,
    alone: its exit code must be 0; its output lines."""
    t0 = time.perf_counter()
    rc, out, err = _tool([f"horovod_tpu_torch.examples.{name}", *args],
                         timeout=timeout)
    if rc != 0:
        raise AssertionError(f"launch/examples/{name}: exit {rc}:\n"
                             f"{out[-3000:]}{err[-3000:]}")
    return out.splitlines(), time.perf_counter() - t0


def _json_lines(lines):
    return [json.loads(ln) for ln in lines if ln.startswith("{")]


def launch_examples():
    """Each user example once on the card, small step counts: the two
    that report a time alone, synthetic_benchmark at ResNet50 and batch
    128 (images/s) and long_context_attention on the flash kernels at
    T 32,768 (its launches, ms); then mnist (20 steps), serve (generate,
    429 under backpressure, drain), merged_trace (timeline beside the
    torch profiler's kernels) and pytorch_mnist (the PyTorch frontend's
    example, 20 steps, through the launcher at -np 1) side by side, as
    four processes on the card: they check what they do and time
    nothing."""
    import tempfile
    import threading
    out = {}
    lines, sec = _example("synthetic_benchmark", [
        "--model", "ResNet50", "--batch-per-chip", str(RESNET["batch"]),
        "--num-iters", str(LAUNCH["resnet_iters"]), "--num-warmup", "2"])
    (bench,) = _json_lines(lines)
    if not bench["images_per_s"] > 0 or bench["device"] != "cuda:0":
        raise AssertionError(f"launch/examples/synthetic_benchmark: {bench}")
    out["synthetic_benchmark"] = dict(bench, seconds=sec)
    lines, sec = _example("long_context_attention", [
        "--use-flash", "--seq-len", str(LAUNCH["lc_seq"]), "--heads", "12"])
    (lc,) = _json_lines(lines)
    counts = dict(lc["flash_launches"])
    # one flash call per ring step (one shard here), warm-up and timed
    if counts != {"flash_fwd": 2, "flash_bwd_dq": 0, "flash_bwd_dkv": 0} or \
            "done: long-context attention OK" not in lines or \
            not math.isfinite(lc["mean_abs_out"]):
        raise AssertionError(f"launch/examples/long_context: {lines[-5:]}")
    out["long_context_attention"] = dict(lc, seconds=sec)
    args = {"mnist": ["--steps", str(LAUNCH["mnist_steps"]),
                      "--batch-per-replica", "64"], "serve": [],
            "merged_trace": [tempfile.mkdtemp(prefix="hvd_example_trace_")],
            "pytorch_mnist": ["--steps", str(LAUNCH["mnist_steps"]),
                              "--batch-size", "64"]}
    ran, errors = {}, {}

    def launched(name):
        """The example through the port's launcher at -np 1."""
        t0 = time.perf_counter()
        job = Launched(["-np", "1", "-H", "localhost:1", "--",
                        sys.executable, "-m",
                        f"horovod_tpu_torch.examples.{name}", *args[name]])
        _check_rc(f"examples/{name}", job.finish(LAUNCH["timeout_s"]), job)
        return [line.partition("<stdout>:")[2].rstrip("\n")
                for _, line in job.lines], time.perf_counter() - t0

    def one(name):
        try:
            ran[name] = launched(name) if name == "pytorch_mnist" else \
                _example(name, args[name])
        except Exception as e:  # noqa: BLE001 - raised below
            errors[name] = e

    threads = [threading.Thread(target=one, args=(n,)) for n in args]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise AssertionError(f"launch/examples: {errors}")
    lines, sec = ran["mnist"]
    done = [ln for ln in lines if ln.startswith("done: final loss")]
    if not done or "cuda:0" not in done[0]:
        raise AssertionError(f"launch/examples/mnist: {lines[-5:]}")
    out["mnist"] = {"seconds": sec, "done": done[0]}
    lines, sec = ran["pytorch_mnist"]
    done = [ln for ln in lines if ln.startswith("done: final loss")]
    if not done or not done[0].endswith("across 1 workers on cuda"):
        raise AssertionError(f"launch/examples/pytorch_mnist: {lines[-5:]}")
    out["pytorch_mnist"] = {"seconds": sec, "done": done[0],
                            "launcher": "-np 1"}
    lines, sec = ran["serve"]
    if "done: serving plane OK (generate + backpressure + drain)" \
            not in lines:
        raise AssertionError(f"launch/examples/serve: {lines[-5:]}")
    out["serve"] = {"seconds": sec, **_json_lines(lines)[-1]}
    lines, sec = ran["merged_trace"]
    (trace,) = _json_lines(lines)
    if not trace["engine_timeline_events"] > 0 or \
            not trace["kernel_events"] > 0:
        raise AssertionError(f"launch/examples/merged_trace: {trace}")
    out["merged_trace"] = dict(trace, seconds=sec)
    return counts, {"leg": "examples", **out, "launches": counts}


def launch_phase(device, card, train_line, out_dir):
    """The launch phase: the static, elastic, serve, run, replicated and
    examples legs in order. The kernels launch in the launched processes;
    their counts come from the scripts' lines or the function's result
    (each process counts its own launches from zero). Returns the counts
    by path: ``launch`` (static + elastic), ``run``, ``replicated`` and
    ``examples``."""
    import torch
    t0 = time.perf_counter()
    counts_static, static = launch_static(train_line, out_dir)
    counts_elastic, elastic = launch_elastic(out_dir)
    serve = launch_serve(device, out_dir)
    torch.cuda.empty_cache()
    counts_run, run = launch_run(train_line)
    counts_rep, replicated = launch_replicated(train_line, out_dir)
    counts_ex, examples = launch_examples()
    counts = {"launch": {k: counts_static[k] + counts_elastic[k]
                         for k in NAMES},
              "run": counts_run, "replicated": counts_rep,
              "examples": counts_ex}
    return counts, {"phase": "launch", "nvidia_smi": card,
                    "seconds": time.perf_counter() - t0,
                    "static": static, "elastic": elastic, "serve": serve,
                    "run": run, "replicated": replicated,
                    "examples": examples, "launches": counts}


def _replay(name, args, expect):
    """``python -m horovod_tpu_torch.verify --conformance <args> --json``
    over one leg's directories: each artifact kind in ``expect`` (kind ->
    how many sets) must be checked, every set must hold records, and the
    replay must find no divergence. Returns {set: {records, divergences}}."""
    rc, text, err = _tool(["horovod_tpu_torch.verify", "--conformance",
                           *args, "--json"])
    try:
        report = json.loads(text)
    except ValueError:
        raise AssertionError(f"check/{name}: conformance exited {rc}: "
                             f"{text}{err}") from None
    kinds = {}
    for entry in report["checked"]:
        kind = entry.split(":")[0]
        kinds[kind] = kinds.get(kind, 0) + 1
    empty = [e for e, n in report["records"].items() if n <= 0]
    if rc != 0 or report["divergences"] or kinds != expect or empty:
        raise AssertionError(f"check/{name}: conformance exited {rc} over "
                             f"{args}: sets {kinds} (want {expect}), "
                             f"empty {empty}: {report['divergences']}")
    return {entry: {"records": n, "divergences": 0}
            for entry, n in report["records"].items()}


def check_phase(card, launch_line):
    """The port's static and protocol checks, then the launch legs'
    artifacts replayed: ``python -m horovod_tpu_torch.lint`` over this
    checkout (no finding), ``python -m horovod_tpu_torch.verify`` (every
    spec clean and exhaustive at the CI bound; every mutant caught, one
    through the CLI), and its ``--conformance`` over the elastic leg's
    KV WAL, journal and the flight dump of its respawn, the serve
    fleet's KV, and the replicated leg's three replica WALs and journal:
    each set must hold records and replay with no divergence. The six
    command-line runs go side by side (each a fresh Python importing
    torch), the mutants in this process meanwhile."""
    from concurrent.futures import ThreadPoolExecutor
    from horovod_tpu_torch.verify import MUTANTS, SPECS, check, make_spec
    from horovod_tpu_torch.verify.cli import CI_DEPTH, CI_MAX_STATES
    t0 = time.perf_counter()
    elastic = launch_line["elastic"]["artifacts"]
    replicated = launch_line["replicated"]["artifacts"]
    with ThreadPoolExecutor(6) as pool:
        lint = pool.submit(_tool, ["horovod_tpu_torch.lint", "--json"])
        verify = pool.submit(_tool, ["horovod_tpu_torch.verify", "--json"])
        mutant_cli = pool.submit(_tool, ["horovod_tpu_torch.verify",
                                         "--mutant",
                                         "epoch_accept_stale_notify"])
        replays = {name: pool.submit(_replay, name, args, expect)
                   for name, args, expect in (
                       ("elastic", [elastic["job"], "--flight-dir",
                                    elastic["end"]],
                        {"kv-wal": 1, "flight": 1, "journal": 1}),
                       ("serve", [launch_line["serve"]["artifacts"]["kv"]],
                        {"kv-wal": 1}),
                       ("replicated", [os.path.dirname(replicated["kv"])],
                        {"kv-wal": LAUNCH["replicas"], "journal": 1}))}
        mutants = {}
        for mutant, (spec, _, _) in sorted(MUTANTS.items()):
            res = check(make_spec(spec, mutant=mutant), depth=CI_DEPTH,
                        max_states=CI_MAX_STATES)
            if not res.violations:
                raise AssertionError(f"check/mutants: {mutant} not caught")
            v = res.violations[0]
            mutants[mutant] = {"invariant": v.invariant,
                               "trace": len(v.trace)}
        replays = {name: f.result() for name, f in replays.items()}
        rc, text, err = lint.result()
        findings = json.loads(text) if text.strip().startswith("[") \
            else None
        if rc != 0 or findings != []:
            raise AssertionError(f"check/lint: exited {rc}: {text}{err}")
        rc, text, err = verify.result()
        results = json.loads(text)["results"] if rc == 0 else []
        specs = {r["spec"]: {"states": r["states"],
                             "transitions": r["transitions"],
                             "depth": r["depth"]} for r in results
                 if r["exhaustive"] and not r["violations"]}
        if rc != 0 or sorted(specs) != sorted(SPECS):
            raise AssertionError(f"check/specs: exited {rc}: {text}{err}")
        rc, text, err = mutant_cli.result()
        if rc != 1 or "INVARIANT VIOLATED" not in text or \
                "  1. " not in text:
            raise AssertionError(f"check/mutant CLI: exited {rc}: "
                                 f"{text}{err}")
    return {"phase": "check", "nvidia_smi": card,
            "seconds": time.perf_counter() - t0, "lint_findings": 0,
            "specs": specs, "mutants_caught": len(mutants),
            "mutants": mutants, "replays": replays}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the nvcc logs, the trace and "
                         "chip_smoke_lines.jsonl (every printed line)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra train step after the counted "
                         "ones (torch.profiler)")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    global _LINES
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        _LINES = os.path.join(opts.out, "chip_smoke_lines.jsonl")
        open(_LINES, "w").close()
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
    for name in FLOAT64_CASES:
        emit({"phase": "kernels", "case": f"{name}_vs_float64",
              "errors": float64_noise(device, name)})

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
    width_lines = width_timings(device)
    for line in width_lines:
        emit(line)
    emit(crossover(device))

    counts = {}
    counts["gpt"], prof, gpt_flops, train_line = train(device, opts.out,
                                                       opts.profile)
    emit(train_line)
    if prof is not None:
        emit(prof)
    counts["widths"], widths_line = widths_phase(device, card)
    emit(widths_line)

    emit(collectives_check(device))
    counts["frontend"], front_line = frontend(device, card, gpt_flops)
    emit(front_line)
    counts["torch_api"], api_line = torch_api_phase(device, card, front_line,
                                                    gpt_flops)
    emit(api_line)
    counts["obs"], obs_line = obs_phase(device, card)
    emit(obs_line)
    counts["tune"], tune_line = tune_phase(device, card, opts.out)
    emit(tune_line)
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
    counts["elastic"], elastic_line = elastic_phase(device, card)
    emit(elastic_line)
    counts["faults"], faults_line = faults_phase(device, card)
    emit(faults_line)
    counts["serve"], serve_line = serve_phase(device, card)
    emit(serve_line)
    launch_counts, launch_line = launch_phase(device, card, train_line,
                                              opts.out)
    counts.update(launch_counts)
    emit(launch_line)
    emit(check_phase(card, launch_line))

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
            "widths": {line["row"]: {k: line["kernels"][name][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_ms_joint")} for line in width_lines},
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
