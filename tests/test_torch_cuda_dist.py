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
exists). Imports torch and the port only (no JAX):

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
