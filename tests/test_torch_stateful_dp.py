"""SyncBatchNorm, make_stateful_train_step, make_eval_step and the per-replica
dropout generator of the port against the reference, on the same weights
and inputs: world 1 in process, world 2 as two gloo processes against a
2-device mesh, and world 4 as data=2 x fsdp=2 with the hierarchical
gradient allreduce against a 4-device mesh of the same layout. The
stateful step trains the tiny ResNet (BottleneckBlock, stages [1, 1], 8
filters, 32x32 images) one step with SGD + momentum 0.9 (``optax.sgd`` in
the reference)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.jax.sync_batch_norm import SyncBatchNorm as RefSyncBN
from horovod_tpu.models import resnet as ref_resnet
from horovod_tpu.parallel import dp as ref_dp
from horovod_tpu.parallel import mesh as mesh_lib
from horovod_tpu_torch.models.convert import from_flax_resnet

import torch_dist_cases as cases
from torch_dist_cases import randomize

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)
# a param moves by lr * g: the gradient tolerance scaled by lr
PARAM = dict(rtol=1e-5, atol=2e-4 * cases.SGD_LR)
REPLICAS = P(("data", "fsdp"))
HIERARCHICAL = {1: False, 2: False, 4: True}


def ref_mesh(world):
    spec = mesh_lib.MeshSpec(data=2, fsdp=2) if world == 4 else \
        mesh_lib.MeshSpec(data=world)
    return mesh_lib.build_mesh(spec, jax.devices()[:world])


@pytest.fixture(scope="module")
def weights():
    """The tiny ResNet's random variables (flax trees) and the same as a
    state_dict of numpy arrays."""
    ref = ref_resnet.ResNet(block_cls=ref_resnet.BottleneckBlock,
                            **cases.RESNET_CFG)
    variables = randomize(jax.eval_shape(
        ref.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3))), 11)
    state = {k: v.numpy() for k, v in from_flax_resnet(
        variables["params"], variables["batch_stats"]).items()}
    return ref, variables, state


@pytest.fixture(scope="module")
def world1(weights):
    hvd.init(device="cpu")
    try:
        return [cases.run_stateful(0, 1, weights[2], False)]
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def world2(weights, tmp_path_factory):
    return cases.spawn(2, tmp_path_factory.mktemp("stateful2"), "stateful",
                       (weights[2], False))


@pytest.fixture(scope="module")
def world4(weights, tmp_path_factory):
    return cases.spawn(4, tmp_path_factory.mktemp("stateful4"), "stateful",
                       (weights[2], True), mesh=(2, 2))


@pytest.fixture(params=[1, 2, 4], ids=lambda w: f"world{w}")
def world(request):
    return request.param, request.getfixturevalue(f"world{request.param}")


def ref_sync_bn(world, momentum):
    """The reference SyncBatchNorm under shard_map (check_vma=False, as the
    reference's steps run): per-device output, input and parameter
    gradients of sum(out * cot) over the local slice, running stats."""
    x, cot, scale, bias = cases.bn_inputs()
    model = RefSyncBN(momentum=momentum)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(cases.BN_FEATURES),
                                 "var": jnp.ones(cases.BN_FEATURES)}}

    def local(v, xl, cl):
        def f(xl, params):
            out, new = model.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, xl,
                use_running_average=False, mutable=["batch_stats"])
            return jnp.sum(out * cl), (out, new["batch_stats"])
        (_, (out, stats)), (dx, dp) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(xl, v["params"])
        ev = model.apply({"params": v["params"], "batch_stats": stats}, xl,
                         use_running_average=True)
        return (out, dx, dp["scale"][None], dp["bias"][None], ev,
                stats["mean"], stats["var"])
    mapped = jax.shard_map(local, mesh=ref_mesh(world),
                           in_specs=(P(), REPLICAS, REPLICAS),
                           out_specs=(REPLICAS,) * 5 + (P(), P()),
                           check_vma=False)
    outs = jax.jit(mapped)(variables, jnp.asarray(x), jnp.asarray(cot))
    return dict(zip(("y", "dx", "dscale", "dbias", "eval", "mean", "var"),
                    (np.asarray(o) for o in outs)))


@pytest.mark.parametrize("momentum", cases.BN_MOMENTA)
def test_sync_batch_norm_matches_reference(world, momentum):
    """Outputs, input and parameter gradients (the backward sums the
    cotangent over the replicas, as psum's transpose does under
    check_vma=False), running statistics and eval-mode outputs."""
    n, outs = world
    want = ref_sync_bn(n, momentum)
    for rank, out in enumerate(outs):
        for key in ("y", "dx", "eval"):
            np.testing.assert_allclose(
                out[f"bn/{momentum}/{key}"],
                cases._slice(want[key], rank, n), err_msg=key,
                **(GRAD if key == "dx" else FWD))
        for key in ("dscale", "dbias"):
            np.testing.assert_allclose(out[f"bn/{momentum}/{key}"],
                                       want[key][rank], err_msg=key, **GRAD)
        for key in ("mean", "var"):
            np.testing.assert_allclose(out[f"bn/{momentum}/{key}"],
                                       want[key], err_msg=key, **FWD)


def test_sync_batch_norm_matches_global_bn(world):
    """The reference's defining property (tests/test_functions_and_
    elastic.py): over the replicas, SyncBatchNorm is plain BatchNorm of the
    concatenated global batch, and every replica's running statistics take
    the global ones (momentum 0.5 from zero mean, unit var)."""
    n, outs = world
    x, _, scale, bias = cases.bn_inputs()
    mean, var = x.mean(0), x.var(0)
    expected = (x - mean) / np.sqrt(var + 1e-5) * scale + bias
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["bn/0.5/y"],
                                   cases._slice(expected, rank, n),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["bn/0.5/mean"], 0.5 * mean,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["bn/0.5/var"], 0.5 + 0.5 * var,
                                   rtol=1e-4, atol=1e-5)


def test_sync_batch_norm_without_a_job_is_local_batch_norm():
    from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm
    x, _, _, _ = cases.bn_inputs()
    bn = SyncBatchNorm(cases.BN_FEATURES, dtype=torch.bfloat16)
    y = bn(torch.tensor(x))
    assert y.dtype == torch.bfloat16
    assert bn.mean.dtype == bn.var.dtype == torch.float32
    np.testing.assert_allclose(
        y.detach().float().numpy(),
        (x - x.mean(0)) / np.sqrt(x.var(0) + 1e-5),
        rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(bn.mean.numpy(), 0.1 * x.mean(0), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def ref_steps(weights):
    """world -> the reference's stateful step and eval results, each
    computed once."""
    memo = {}

    def get(world):
        if world not in memo:
            memo[world] = ref_stateful_step(weights[0], weights[1], world)
        return memo[world]
    return get


def ref_stateful_step(ref, variables, world):
    mesh = ref_mesh(world)
    opt = optax.sgd(cases.SGD_LR, momentum=0.9)

    def loss_fn(params, state, b, rng):
        logits, new = ref.apply({"params": params, "batch_stats": state},
                                b["image"], train=True,
                                mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, b["label"]).mean()
        return loss, (new["batch_stats"], {})

    step = ref_dp.make_stateful_train_step(
        loss_fn, opt, mesh, donate=False, hierarchical=HIERARCHICAL[world])
    params, stats = variables["params"], variables["batch_stats"]
    batch = {k: jnp.asarray(v) for k, v in cases.resnet_batch(world).items()}
    batch["label"] = batch["label"].astype(jnp.int32)
    out = step(ref_dp.replicate(params, mesh),
               ref_dp.replicate(opt.init(params), mesh),
               ref_dp.replicate(stats, mesh),
               ref_dp.shard_batch(batch, mesh), jax.random.key(0))
    evaluate = ref_dp.make_eval_step(
        lambda v, b: ref.apply(v, b["image"], train=False), mesh)
    logits = evaluate(ref_dp.replicate(variables, mesh),
                      ref_dp.shard_batch(batch, mesh))
    tree = jax.tree_util.tree_map(np.asarray, out)
    res = {"loss": tree.loss, "eval_logits": np.asarray(logits)}
    for prefix, sd in (
            ("param", from_flax_resnet(tree.params)),
            ("momentum", from_flax_resnet(tree.opt_state[0].trace)),
            ("stats", from_flax_resnet(tree.params, tree.model_state))):
        res.update({f"{prefix}/{k}": v.numpy() for k, v in sd.items()
                    if prefix != "stats" or k.endswith((".mean", ".var"))})
    return res


def test_stateful_step_matches_reference(world, ref_steps):
    """Loss, params, momentum buffers and the replica-averaged running
    statistics after one step; the integer aux leaf passes through
    unchanged (not summed, unlike make_train_step's)."""
    n, outs = world
    want = ref_steps(n)
    names = sorted(k for k in want if k.startswith(("param/", "momentum/",
                                                    "stats/")))
    for rank, got in enumerate(outs):
        assert sorted(k for k in got if k.startswith(
            ("param/", "momentum/", "stats/"))) == names
        np.testing.assert_allclose(got["loss"], want["loss"], **FWD)
        for key in names:
            tol = {"param": PARAM, "momentum": GRAD,
                   "stats": FWD}[key.split("/")[0]]
            np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                       **tol)
        assert int(got["rank_plus_one"]) == rank + 1


def test_eval_step_gathers_logits_in_rank_order(world, ref_steps):
    n, outs = world
    want = ref_steps(n)["eval_logits"]
    assert want.shape == (2 * n, 10)
    for got in outs:
        np.testing.assert_allclose(got["eval_logits"], want, **FWD)


def test_dropout_masks_differ_across_replicas_and_repeat(world):
    """The step's generator folds the replica index into the seed: two
    replicas on the same images and weights draw different masks, and a
    rerun with the same seed draws the same ones."""
    n, outs = world
    for out in outs:
        np.testing.assert_array_equal(out["mask0"], out["mask1"])
        live = out["mask0"][out["mask0"] >= 0]
        assert live.size > 20 and 0.3 < live.mean() < 0.7  # rate 0.5
    for a in range(n):
        for b in range(a + 1, n):
            assert not np.array_equal(outs[a]["mask0"], outs[b]["mask0"])


def test_stateful_step_remat_and_seeds():
    """remat gives the same step, running statistics included (the
    recomputation would update them twice); distinct replica indices give
    distinct seeds; train mode without a seed needs no generator for
    BatchNorm models."""
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from horovod_tpu_torch.parallel import dp
    assert dp.fold_in(1, 0) != dp.fold_in(1, 1) != dp.fold_in(2, 1)
    assert dp.fold_in(1, 0) == dp.fold_in(1, 0) < 2 ** 63
    batch = {k: torch.tensor(v) for k, v in cases.resnet_batch(1).items()}
    hvd.init(device="cpu")
    try:
        results = []
        for remat in (False, True):
            model = ResNet(block_cls=BottleneckBlock, **cases.RESNET_CFG)
            model.reset_parameters(torch.Generator().manual_seed(3))
            opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)

            def loss_fn(m, b):
                return torch.nn.functional.cross_entropy(
                    m(b["image"], train=True), b["label"]), {}
            out = dp.make_stateful_train_step(model, loss_fn, opt,
                                              remat=remat, device="cpu")(
                batch)
            results.append((out.loss, model.state_dict()))
        assert torch.equal(results[0][0], results[1][0])
        for key, value in results[0][1].items():
            assert torch.equal(value, results[1][1][key]), key
    finally:
        hvd.shutdown()
