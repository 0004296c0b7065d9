"""On several cards: the multi-process cases of tests/torch_dist_cases.py on
NCCL, one process per card, against the same cases on gloo on the CPU
(which tests/test_torch_collectives_more.py and
tests/test_torch_stateful_dp.py hold against the reference): every
collective over data, fsdp and both at data=2 x fsdp=2, and SyncBatchNorm,
the stateful step with the hierarchical allreduce, make_eval_step and the
dropout generator at data=2 and at data=2 x fsdp=2; at data=2 x fsdp=2 the
bucketed exchange (fp32, bf16 and int8 wires, replicated and ZeRO-1, the
hooks launching buckets during the backward), the ZeRO-1 and int8 steps,
the quantized allreduce and Adasum (tests/test_torch_bucketing.py,
test_torch_zero.py and test_torch_adasum.py hold the same cases on gloo
against the reference); at world 4 the name-negotiated eager ops (every
op and dtype, out-of-order submission, the three join cases, the ragged
allgather, a dtype mismatch) and DistributedOptimizer over its whole
option matrix on MNIST (tests/test_torch_eager.py and
test_torch_distributed_optimizer.py hold them on gloo against the
reference); at world 4 the sequence, tensor, pipeline and expert
parallelism of the CPU tests (test_torch_sequence_parallel.py,
test_torch_tp_pp.py, test_torch_expert_parallel.py) against gloo, and
chip_smoke.py's parallel entries at full size with each axis spanning the
four cards, each rank against one card's result on its own card (they
raise on disagreement; their numbers land in
chiprun_out/torch_cuda_dist_parallel_<axis>.json where that directory
exists); and elastic training: GPT-2 small with ZeRO-1 AdamW under
elastic.run on four cards, the stand-in driver of torch_dist_cases.py
running the rendezvous, rank 3 killed after a commit and a step (4 -> 3, its
shard from its buddy's replica, detected through the groups' timeout) and a
fresh process joining (3 -> 4), on the fp32 and int8 reshard wires (numbers
in chiprun_out/torch_cuda_dist_elastic_<wire>.json; ``-k elastic`` runs
them alone); and the serving plane's TP LM at GPT-2 small's widths over a
``model`` axis of the four cards, fp32 and int8 wires, against one card,
with a ServingLoop on rank 0 while the others follow (its numbers printed
as one JSON line and in chiprun_out/torch_cuda_dist_serve.json; ``-k
serve`` runs it alone).
Imports torch and the port only (no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_dist.py -q

Every test skips where fewer CUDA devices than its world are present.
Tolerances: those of the CPU tests against the reference (TF32 is off on
the cards)."""

import numpy as np
import pytest
import torch

import torch_dist_cases as cases

TOL = {"float32": 1e-6, "bfloat16": 8e-3, "int32": 0.0}
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)
PARAM = dict(rtol=1e-5, atol=2e-4 * cases.SGD_LR)
MESH = {2: (2, 1), 4: (2, 2)}


def cards(world):
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices")


def both_backends(world, tmp_path, job, job_args=()):
    """(NCCL on the cards, gloo on the CPU) results of one job."""
    out = []
    for dev in ("cuda", "cpu"):
        (tmp_path / dev).mkdir()
        out.append(cases.spawn(world, tmp_path / dev, job, job_args,
                               timeout=300, mesh=MESH[world], device=dev))
    return out


def tiny_resnet_state():
    """Random weights of the tiny ResNet, BatchNorm scales away from the
    zero init so every branch carries gradient."""
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
    model = ResNet(block_cls=BottleneckBlock, **cases.RESNET_CFG)
    g = torch.Generator().manual_seed(12)
    model.reset_parameters(g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.cuda
def test_nccl_collectives_world4_match_gloo(tmp_path):
    cards(4)
    nccl, gloo = both_backends(4, tmp_path, "collectives_more")
    for rank, (got, want) in enumerate(zip(nccl, gloo)):
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            name = key.split("|")[0]
            dtype = cases.MORE_CASES[name][1] if name in cases.MORE_CASES \
                else "int32"
            if dtype == "mixed":
                dtype = cases.GROUPED_DTYPES[int(key.split("|")[2])]
            np.testing.assert_allclose(got[key], w, rtol=TOL[dtype],
                                       atol=TOL[dtype],
                                       err_msg=f"{key} rank {rank}")


def slice5_tolerance(job, key, want):
    """Tolerance of one result of the bucketing, zero and adasum jobs on
    NCCL against gloo: int8 results within two quantization levels of the
    largest value (a gradient a few ulps off may round to the next level);
    bf16 wire within its resolution; the rest within the fp32 forward and
    gradient tolerances (TF32 off; the card's GEMMs, flash kernels and
    reduction order round differently from the CPU's)."""
    if "int8" in key or key.startswith("quant|"):
        return dict(rtol=0.0, atol=2 * float(np.abs(want).max()) / 127 + 1e-7)
    if "bf16" in key:
        return dict(rtol=1e-2, atol=1e-4)
    if job == "bucketing" and not key.endswith("losses"):
        return dict(rtol=5e-3, atol=5e-4 * cases.BUCKET_LR)
    return FWD


def replica_wide(job, key):
    """Whether every replica of the world holds the same value of ``key``:
    not so for the Adasum group cases over "data" or "fsdp" alone (one
    result per subgroup), nor over ("fsdp", "data"), where the reference
    numbers the exchange partners in the mesh's order (``lax.ppermute``)
    and the halves in the order named (``axis_index``), so its replicas
    end with different results, and the port's with the same ones."""
    return not (job == "adasum" and key.startswith("group|")
                and key.split("|")[1] != "data+fsdp")


@pytest.mark.cuda
@pytest.mark.parametrize("job", ["bucketing", "zero", "adasum"])
def test_nccl_slice5_world4_matches_gloo(job, tmp_path):
    """The bucketed, int8, ZeRO-1 and Adasum cases at data=2 x fsdp=2: on
    NCCL the same results as on gloo, the same bucket launches before the
    backward's end, and every replica the same numbers where the results
    are replica-wide."""
    cards(4)
    if job == "bucketing":
        from horovod_tpu_torch.ops import _build
        _build.build()  # once, before four processes want the kernels
    args = (cases.gpt_state(),) if job == "bucketing" else ()
    nccl, gloo = both_backends(4, tmp_path, job, args)
    for rank, (got, want) in enumerate(zip(nccl, gloo)):
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            if key.endswith(("early", "units")) or w.dtype.kind in "US":
                np.testing.assert_array_equal(got[key], w, err_msg=key)
                continue
            if job == "bucketing" and \
                    key.split("|")[-1].startswith("param/"):
                continue  # compared as the change, delta/
            np.testing.assert_allclose(
                got[key], w, err_msg=f"{job} {key} rank {rank}",
                **slice5_tolerance(job, key, w))
    for key, value in nccl[0].items():
        if replica_wide(job, key):
            np.testing.assert_array_equal(nccl[-1][key], value, err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_nccl_stateful_step_matches_gloo(world, tmp_path):
    """SyncBatchNorm, one stateful step (hierarchical at world 4) and the
    gathered eval logits agree with gloo; dropout masks (the card's
    generator draws other numbers than the CPU's) differ across replicas
    and repeat on a rerun."""
    cards(world)
    nccl, gloo = both_backends(world, tmp_path, "stateful",
                               (tiny_resnet_state(), world == 4))
    for rank, (got, want) in enumerate(zip(nccl, gloo)):
        for key, w in want.items():
            if key.startswith("mask"):
                continue
            kind = key.split("/")[0]
            tol = {"param": PARAM, "momentum": GRAD}.get(kind, FWD)
            if kind == "bn" and key.endswith(("/dx", "/dscale", "/dbias")):
                tol = GRAD
            np.testing.assert_allclose(got[key], w, err_msg=f"{key} {rank}",
                                       **tol)
        np.testing.assert_array_equal(got["mask0"], got["mask1"])
    assert not np.array_equal(nccl[0]["mask0"], nccl[1]["mask0"])


def eager_tolerance(key: str) -> dict:
    """Integers and the join and aux results equal, fp32 within 1e-6,
    16-bit floats within the reference test's 1e-2."""
    dtype = key.split("|")[1] if key.count("|") >= 2 else "int32"
    if dtype in ("bfloat16", "float16", "mixed"):
        return dict(rtol=1e-2, atol=0.0)
    if dtype == "float32":
        return dict(rtol=1e-6, atol=0.0)
    return dict(rtol=0.0, atol=0.0)


@pytest.mark.cuda
def test_nccl_eager_world4_matches_gloo(tmp_path):
    """The eager ops on NCCL (negotiated on gloo, run on a side stream of
    each card) give gloo's results: out-of-order names, joins and the
    mismatch included."""
    cards(4)
    nccl, gloo = both_backends(4, tmp_path, "eager")
    for rank, (got, want) in enumerate(zip(nccl, gloo)):
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            if w.dtype.kind in "US":
                np.testing.assert_array_equal(got[key], w, err_msg=key)
                continue
            np.testing.assert_allclose(got[key], w, err_msg=f"{key} {rank}",
                                       **eager_tolerance(key))


@pytest.mark.cuda
def test_nccl_distributed_optimizer_world4_matches_gloo(tmp_path):
    """Every DistributedOptimizer configuration on MNIST: the parameters
    after each microstep on NCCL equal gloo's within rtol 1e-5 (int8: all
    but the rare one-level flips of another rounding order)."""
    cards(4)
    nccl, gloo = both_backends(4, tmp_path, "dist_opt",
                               ({"mnist": cases.mnist_tree()},))
    tol = dict(rtol=1e-5, atol=1e-6)
    for got, want in zip(nccl, gloo):
        assert sorted(got) == sorted(want)
        for cfg in cases.DOPT_MODELS["mnist"]:
            keys = [k for k in want if k.startswith(f"mnist|{cfg}|")]
            if cases.DOPT_CONFIGS[cfg][1] == "int8":
                bad, total, _ = cases.int8_mismatches(
                    {k: got[k] for k in keys}, {k: want[k] for k in keys},
                    tol)
                assert bad <= max(2, cases.INT8_FLIP_RATE * total), cfg
                continue
            for k in keys:
                np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


PAR_AXES = {"sp": "seq", "tp": "model", "pp": "pipe", "ep": "expert"}


def par_tolerance(job: str, key: str, want) -> dict:
    """int8 inference within two quantization levels of the largest
    value; the ring's mutated gradients and the rest within the fp32
    gradient tolerance (the card's flash kernels and GEMMs round otherwise
    than the CPU's plain versions)."""
    if key == "infer_int8":
        return dict(rtol=0.0, atol=2 * float(np.abs(want).max()) / 127)
    return GRAD


@pytest.mark.cuda
@pytest.mark.parametrize("job", sorted(PAR_AXES))
def test_nccl_parallel_world4_matches_gloo(job, tmp_path):
    """Each parallel job of the CPU tests at world 4, its axis spanning
    the world: on NCCL the same outputs and gradients as on gloo."""
    cards(4)
    if job == "sp":
        from horovod_tpu_torch.ops import _build
        _build.build()  # once, before four processes want the kernels
    out = []
    for dev in ("cuda", "cpu"):
        (tmp_path / dev).mkdir()
        out.append(cases.spawn(4, tmp_path / dev, job, timeout=300,
                               mesh={"data": 1, PAR_AXES[job]: 4},
                               device=dev))
    for rank, (got, want) in enumerate(zip(*out)):
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            if w.dtype.kind in "US":
                np.testing.assert_array_equal(got[key], w, err_msg=key)
                continue
            np.testing.assert_allclose(got[key], w,
                                       err_msg=f"{job} {key} rank {rank}",
                                       **par_tolerance(job, key, w))


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["seq", "model", "pipe", "expert"])
def test_parallel_full_size_world4_matches_one_card(axis, tmp_path):
    """chip_smoke.py's parallel entries over ``axis`` = 4 cards: the ring
    and Ulysses at T = 32,768 (8,192 per rank; 3 heads per rank under
    Ulysses) and the plain ring at T = 8,192, tp_mlp over model = 4, 4
    pipeline stages of 3 of GPT-2 small's blocks, the MoE with 2 experts
    per rank at capacity factors 1.25 and 0.5 (the second drops tokens).
    Each rank computes one card's result on its own card and raises
    unless its part agrees (bf16: a few ulps and normwise 1e-2; fp32:
    rtol 2e-4 / atol 2e-5, gradients 2e-3 / 2e-4)."""
    import json
    import os
    cards(4)
    from horovod_tpu_torch.ops import _build
    _build.build()
    outs = cases.spawn(4, tmp_path, "par_full", (axis,), timeout=600,
                       mesh={"data": 1, axis: 4}, device="cuda")
    entries = [json.loads(str(o["entries"])) for o in outs]
    for rank_entries in entries:
        for e in rank_entries:
            assert e["world"] == 4
    launches = json.loads(str(outs[0]["launches"]))
    if axis in ("seq", "pipe"):
        assert all(launches.values()), launches
    if os.path.isdir("chiprun_out"):
        with open(f"chiprun_out/torch_cuda_dist_parallel_{axis}.json",
                  "w") as f:
            json.dump({"rank0": entries[0], "launches": launches,
                       "card": torch.cuda.get_device_name(0)}, f)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["none", "int8"])
def test_elastic_gpt_small_zero1_kill_and_join(tmp_path, wire):
    """Four cards, GPT-2 small, ZeRO-1: rank 3 exits hard after a commit
    and one more step; the survivors detect the loss within the groups'
    timeout (30 s), re-rendezvous at world 3 at a new store endpoint,
    reshard the moments (rank 3's slice from its buddy's committed
    replica) and train on; a fresh process then joins (3 -> 4) and gets
    the state through sync. After each resize the gathered moments equal
    the trained ranks' shards (bit-equal on fp32, within the codec's bound
    on int8), the parameters are equal on every rank, the loss finite."""
    import json
    import os
    cards(4)
    kv = cases.StandInKV()
    try:
        res = cases.run_elastic_gpt(tmp_path, kv, wire, device="cuda",
                                    world=4, steps=8, join_after=5,
                                    timeout=240, model="small")
    finally:
        kv.stop()
    logs = {s: json.loads(str(r["log"])) for s, r in res.items()}
    for s in range(4):
        assert int(res[s]["world"]) == 4
        assert all(np.isfinite(logs[s]["losses"]))
    for k in res[0]:
        if k.startswith("param/"):
            for s in (1, 2, 3):
                np.testing.assert_array_equal(res[s][k], res[0][k])
    cases.moments_check(res, 1, wire)
    cases.moments_check(res, 2, wire)
    death = json.loads(str(np.load(tmp_path / "victim_log.npy")))["death"] \
        if (tmp_path / "victim_log.npy").exists() else None
    report = {"wire": wire, "card": torch.cuda.get_device_name(0),
              "group_timeout_s": 30, "survivors": {}}
    for s in (0, 1, 2):
        faults = [e for e in logs[s]["events"] if e[0] == "fault"]
        assert len(faults) == 1, logs[s]["events"]
        snap = json.loads(str(res[s]["metrics"]))
        fams = {m["name"]: m["samples"][0] for m in snap["metrics"]}
        report["survivors"][s] = {
            "fault_wall": faults[0][3], "fault": faults[0][4],
            "detection_s": None if death is None else faults[0][3] - death,
            "hvd_elastic_recovery_seconds": fams[
                "hvd_elastic_recovery_seconds"],
            "hvd_resize_bytes": fams["hvd_resize_bytes"]["value"],
            "hvd_resize_seconds": fams["hvd_resize_seconds"],
            "commit_ms": logs[s]["commit_ms"],
            "resizes": [{k: float(res[s][f"r{i}/{k}"]) for k in (
                "gen", "old_world", "new_world", "seconds")}
                for i in range(int(res[s]["n_resizes"]))],
            "train_seconds": logs[s]["seconds"]}
    if os.path.isdir("chiprun_out"):
        with open(f"chiprun_out/torch_cuda_dist_elastic_{wire}.json",
                  "w") as f:
            json.dump(report, f, indent=1)


@pytest.mark.cuda
def test_serve_tp_lm_full_width_world4(tmp_path):
    """make_tp_lm_step at GPT-2 small's widths (vocab 50257, hidden 768,
    mlp 3072, 12 layers) over model = 4 cards on NCCL, on 8 ragged rows
    in bucket 256: fp32 greedy tokens equal to the same model on one card
    and its logits within rtol 1e-4 / atol 1e-4; both wires against the
    same world of 4 on gloo (the CPU), fp32 within rtol 1e-4 / atol 1e-4;
    the int8 wire's logits, against fp32 and against gloo's int8, within
    the bound the codec puts on them at a world of 4
    (chip_smoke.serve_int8_probe, from the ranks' partial sums on one
    card): a value that a GEMM's summation order moves across a rounding
    boundary lands one int8 level over, and the later layers carry that
    on. The rows past rtol/atol 1e-4 of gloo's int8 and the share of
    rows whose tokens agree are reported. Then rank 0
    serves 16 requests through a ServingLoop on the int8 step while ranks
    1-3 follow: every request ok with the tokens of its prompt decoded
    alone, every rank out after stop()."""
    import json
    import os
    import chip_smoke
    from horovod_tpu_torch.serve.executor import (activation_wire_report,
                                                  make_tp_lm_step)
    cards(4)
    dims = {k: v for k, v in chip_smoke.SERVE_GPT.items() if k != "seed"}
    mesh = {"data": 1, "model": 4}
    for d in ("tp", "gloo", "loop"):
        (tmp_path / d).mkdir()
    res = cases.spawn(4, tmp_path / "tp", "serve_tp", (dims, 8, 256, False),
                      timeout=600, mesh=mesh, device="cuda")
    lead = res[0]
    np.testing.assert_array_equal(lead["none|tokens"], lead["one|tokens"])
    np.testing.assert_allclose(lead["none|logits"], lead["one|logits"],
                               rtol=1e-4, atol=1e-4)
    for r in res[1:]:
        assert int(r["none|followed"]) == int(r["int8|followed"]) == 7
    gloo = cases.spawn(4, tmp_path / "gloo", "serve_tp",
                       (dims, 8, 256, False, False), timeout=600, mesh=mesh)
    np.testing.assert_allclose(lead["none|logits"], gloo[0]["none|logits"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(lead["none|tokens"],
                                  gloo[0]["none|tokens"])
    one, _ = make_tp_lm_step(compression=None, device="cuda:0", axis=None,
                             **dims)
    _, bound, _, _ = chip_smoke.serve_int8_probe(
        one.model, *cases.serve_inputs(dims["vocab"], 8, 256), world=4)
    del one
    bound = bound.cpu().numpy()
    row_err = np.abs(lead["int8|logits"] - lead["none|logits"]).max(-1)
    gloo_diff = np.abs(lead["int8|logits"] - gloo[0]["int8|logits"])
    gloo_err = gloo_diff.max(-1)
    assert (row_err <= bound).all(), (row_err, bound)
    assert (gloo_err <= bound).all(), (gloo_err, bound)
    loop = cases.spawn(4, tmp_path / "loop", "serve_loop",
                       (dims, "int8", 16, 4), timeout=600, mesh=mesh,
                       device="cuda")
    assert list(loop[0]["status"]) == ["ok"] * 16
    np.testing.assert_array_equal(loop[0]["tokens"], loop[0]["alone"])
    assert len({int(r["followed"]) for r in loop[1:]}) == 1
    report = {
        "card": torch.cuda.get_device_name(0), "world": 4,
        "wire": activation_wire_report(dims["hidden"], dims["layers"], 4),
        "step_ms": {w: float(lead[f"{w}|ms"]) for w in ("none", "int8")},
        "fp32_vs_one_card_max_abs_err": float(
            np.abs(lead["none|logits"] - lead["one|logits"]).max()),
        "fp32_vs_gloo_max_abs_err": float(
            np.abs(lead["none|logits"] - gloo[0]["none|logits"]).max()),
        "int8_vs_gloo_int8_by_row": gloo_err.tolist(),
        "int8_vs_gloo_int8_rows_past_1e-4": int((gloo_diff > 1e-4 + 1e-4 *
                                                 np.abs(gloo[0]["int8|logits"])
                                                 ).any(-1).sum()),
        "int8_vs_fp32_max_abs_err_by_row": row_err.tolist(),
        "int8_bound_by_row": bound.tolist(),
        "int8_token_agreement": float(
            (lead["int8|tokens"] == lead["none|tokens"]).mean()),
        "loop_requests_ok": 16,
        "followed_steps": int(loop[1]["followed"])}
    print(json.dumps(report))
    if os.path.isdir("chiprun_out"):
        with open("chiprun_out/torch_cuda_dist_serve.json", "w") as f:
            json.dump(report, f, indent=1)
