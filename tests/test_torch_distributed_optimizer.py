"""The port's ``DistributedOptimizer`` (``horovod_tpu_torch/optimizer.py``)
against the reference's ``horovod_tpu.jax.DistributedOptimizer`` inside
``shard_map``, at worlds 1, 2 and 4 (data 2 x fsdp 2), on the tiny GPT and
on MNIST with ``from_flax_*`` weights.

Both sides get the same gradients (``torch_dist_cases.grid_grads``: every
rank its own per microstep, one leaf zero on the reference's side and
absent on the port's), so what is compared is the reduction, the wire, the
accumulation and the update: SGD with momentum and AdamW with weight decay;
no wire, fp16, bf16 and int8 (in the reference's leaf order and layout);
Average, Sum and Adasum; two backward passes per step with and without
averaging the aggregate; a predivide factor of 2. The parameters after
every microstep agree within rtol 1e-5 / atol 1e-6; with int8, all but
the rare elements that another rounding of XLA's fused exchange moves by
one int8 level (``torch_dist_cases.INT8_FLIP_RATE``). Adasum is held with
SGD: AdamW divides each element by its own gradient's size, so where
Adasum's combination cancels an element to rounding noise, either
framework's update of it may be anything in [-lr, lr] (the note in
tests/test_torch_dp.py). Also: a state_dict round trip in the middle of
an accumulation, and the reference's refusals."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.jax import DistributedOptimizer as RefDistributedOptimizer
from horovod_tpu.jax.compression import Compression as RefCompression
from horovod_tpu.models.gpt import GptDecoder as RefGpt
from horovod_tpu.models.mnist import MnistConvNet as RefMnist
from horovod_tpu.models import resnet as ref_resnet
from horovod_tpu.models.transformer import BertEncoder as RefBert
from horovod_tpu.parallel import collectives as rc
from horovod_tpu.parallel import dp as ref_dp
from horovod_tpu.parallel import mesh as mesh_lib

import torch_dist_cases as cases

WORLDS = (1, 2, 4)
TOL = dict(rtol=1e-5, atol=1e-6)
AXES = ("data", "fsdp")


def ref_params(model: str) -> dict:
    """The flax weights of the tiny ``model`` (seed 0), as numpy."""
    if model == "gpt":
        ref, x = RefGpt(dtype=jnp.float32, **cases.GPT_CFG), \
            jnp.zeros((1, 8), jnp.int32)
    elif model == "bert":
        ref, x = RefBert(dtype=jnp.float32, **cases.BERT_CFG), \
            jnp.zeros((1, 8), jnp.int32)
    elif model == "resnet":
        ref = ref_resnet.ResNet(block_cls=ref_resnet.BottleneckBlock,
                                dtype=jnp.float32, **cases.RESNET_CFG)
        params = ref.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                          train=False)["params"]
        return jax.tree_util.tree_map(np.asarray, params)
    else:
        ref, x = RefMnist(), jnp.zeros((1, 28, 28, 1))
    params = ref.init(jax.random.key(0), x)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def ref_mesh(world: int):
    data, fsdp = cases.MESHES[world]
    return mesh_lib.build_mesh(mesh_lib.MeshSpec(data=data, fsdp=fsdp),
                               jax.devices()[:world])


def stacked_grads(tree, model: str, world: int, step: int,
                  smooth: bool = False):
    """Every rank's given gradients of microstep ``step``, stacked on a
    leading replica axis."""
    per_rank = [cases.grid_grads(tree, model, r, step, smooth)
                for r in range(world)]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *per_rank)


REF_OPTS = {"sgd": lambda: optax.sgd(cases.DOPT_LR["sgd"], momentum=0.9),
            "adamw": lambda: optax.adamw(cases.DOPT_LR["adamw"],
                                         weight_decay=cases.DOPT_WD)}


def ref_dist_opt(model: str, tree: dict, cfg: str, world: int) -> list:
    """The reference's DistributedOptimizer inside shard_map over the
    replica axes, on the same gradients: the port-named parameters after
    each microstep."""
    opt_name, wire, op, bpps, avg, pre = cases.DOPT_CONFIGS[cfg]
    dopt = RefDistributedOptimizer(
        REF_OPTS[opt_name](), op=getattr(rc, op),
        compression=getattr(RefCompression, wire),
        backward_passes_per_step=bpps, average_aggregated_gradients=avg,
        gradient_predivide_factor=pre)
    mesh = ref_mesh(world)

    def local(p, s, g):
        g = jax.tree_util.tree_map(lambda x: x[0], g)
        updates, s = dopt.update(g, s, p)
        return optax.apply_updates(p, updates), s

    update = jax.jit(jax.shard_map(local, mesh=mesh,
                                   in_specs=(P(), P(), P(AXES)),
                                   out_specs=(P(), P()), check_vma=False))
    params = ref_dp.replicate(tree, mesh)
    state = ref_dp.replicate(dopt.init(tree), mesh)
    out = []
    for k in range(cases.GRAD_STEPS):
        g = ref_dp.shard_batch(stacked_grads(tree, model, world, k,
                                             smooth=wire == "int8"), mesh)
        params, state = update(params, state, g)
        out.append({n: v.numpy() for n, v in cases.from_flax(
            model, jax.tree_util.tree_map(np.asarray, params)).items()})
    return out


@pytest.fixture(scope="module")
def trees():
    return {m: ref_params(m) for m in cases.DOPT_MODELS}


@pytest.fixture(scope="module")
def port(trees, tmp_path_factory):
    return {w: cases.spawn(w, tmp_path_factory.mktemp(f"dopt{w}"),
                           "dist_opt", (trees,), mesh=cases.MESHES[w],
                           timeout=300) for w in WORLDS}


MATRIX = [(m, cfg) for m, cfgs in cases.DOPT_MODELS.items() for cfg in cfgs]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("model,cfg", MATRIX)
def test_distributed_optimizer_matches_reference(trees, port, model, cfg,
                                                 world):
    want = ref_dist_opt(model, trees[model], cfg, world)
    _, wire, _, bpps, _, _ = cases.DOPT_CONFIGS[cfg]
    start = {n: v.numpy() for n, v in cases.from_flax(
        model, trees[model]).items()}
    for out in port[world]:
        for k, params in enumerate(want):
            got = {n: out[f"{model}|{cfg}|{k}|{n}"] for n in params}
            if bpps == 2 and k % 2 == 0:
                # off the boundary nothing moves
                for n, g in got.items():
                    prev = start[n] if k == 0 else \
                        out[f"{model}|{cfg}|{k - 1}|{n}"]
                    np.testing.assert_array_equal(g, prev, err_msg=n)
            if wire != "int8":
                for n, w in params.items():
                    np.testing.assert_allclose(got[n], w, err_msg=f"{k} {n}",
                                               **TOL)
                continue
            # int8: all but the rare one-level flips of XLA's rounding
            # (torch_dist_cases.INT8_FLIP_RATE), which stay within a level
            bad, total, worst = cases.int8_mismatches(got, params, TOL)
            moved = max(np.max(np.abs(params[n] - start[n])) for n in params)
            assert bad <= max(2, cases.INT8_FLIP_RATE * total), (k, bad)
            assert worst <= 2 * moved / 127, (k, worst, moved)


def test_state_dict_round_trip_mid_accumulation():
    """Saved after the first microstep of two and loaded into a fresh
    model and optimizer, the run goes on exactly as without the break."""
    tree = ref_params("mnist")
    hvd.init(device="cpu")
    try:
        for cfg in ("adamw_bpps2_sum", "adamw_int8_predivide_bpps2"):
            whole = cases.dopt_run("mnist", tree, cfg, 0, 1)
            broken = cases.dopt_run("mnist", tree, cfg, 0, 1, resume_at=0)
            assert whole.keys() == broken.keys()
            for key, v in whole.items():
                np.testing.assert_array_equal(broken[key], v, err_msg=key)
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("kw,match", [
    (dict(op="Sum", gradient_predivide_factor=2.0),
     "gradient_predivide_factor supported only with Average"),
    (dict(op="Adasum", gradient_predivide_factor=0.5),
     "gradient_predivide_factor supported only with Average"),
    (dict(backward_passes_per_step=0),
     "backward_passes_per_step must be >= 1")])
def test_refusals_match_reference(kw, match):
    ref_kw = dict(kw)
    port_kw = dict(kw)
    if "op" in kw:
        ref_kw["op"] = getattr(rc, kw["op"])
        port_kw["op"] = getattr(hvd, kw["op"])
    with pytest.raises(ValueError, match=match):
        RefDistributedOptimizer(optax.sgd(0.1), **ref_kw)
    model = torch.nn.Linear(2, 2)
    hvd.init(device="cpu")
    try:
        with pytest.raises(ValueError, match=match):
            hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1), **port_kw)
    finally:
        hvd.shutdown()


def test_wrapper_shares_the_inner_optimizer():
    """param_groups and state are the inner optimizer's: a learning-rate
    change through either reaches both, and zero_grad clears the
    parameters' gradients."""
    model = torch.nn.Linear(3, 2)
    hvd.init(device="cpu")
    try:
        inner = torch.optim.AdamW(model.parameters(), lr=0.1)
        opt = hvd.DistributedOptimizer(inner)
        assert opt.param_groups is not inner.param_groups
        assert all(a is b for a, b in zip(opt.param_groups,
                                          inner.param_groups))
        opt.param_groups[0]["lr"] = 0.5
        assert inner.param_groups[0]["lr"] == 0.5
        model(torch.ones(1, 3)).sum().backward()
        opt.step()
        assert opt.state is inner.state and len(inner.state) == 2
        opt.zero_grad()
        assert all(p.grad is None for p in model.parameters())
        assert opt.state_dict()["count"] == 1
    finally:
        hvd.shutdown()
