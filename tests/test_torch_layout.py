"""The int8 wire in the reference's leaf order and layout, and zero-filled
gradients on the replicated path, against the reference's
``dp.make_train_step``.

The int8 exchange quantizes 256-element blocks of the fused gradients, so
its result depends on which elements share a block. The reference fuses
the leaves in jax's sorted-key order with flax layouts (Dense kernels
``[in, out]``, conv kernels ``[kh, kw, in, out]``); the port lays its
gradients out so (``bucketing.reference_layout``, from the leaves
``models/convert.py`` tags). The tiny GPT, BERT and ResNet-18, with
``from_flax_*`` weights, take two int8 steps (SGD with momentum),
replicated and ZeRO-1, with and without 16 KiB buckets, at worlds 1 and 2,
and match the reference's int8 steps within rtol 1e-5 / atol 1e-6, far
below one quantization level of the update.

A parameter without a gradient reduces as zeros and is stepped, as
``jax.value_and_grad`` gives it a zero gradient: an AdamW step (weight
decay 0.1) of MNIST with one parameter out of the loss matches
``optax.adamw`` on both paths.

As in tests/test_torch_distributed_optimizer.py the gradients are given
(the loss is the inner product of the parameters with them), so both
frameworks quantize the same bits."""

import numpy as np
import jax
import pytest
import torch

from horovod_tpu.jax.compression import Compression as RefCompression
from horovod_tpu.parallel import dp as ref_dp
from horovod_tpu.parallel import zero as ref_zero
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.parallel.bucketing import reference_layout

import torch_dist_cases as cases
from test_torch_distributed_optimizer import (REF_OPTS, ref_mesh, ref_params,
                                              stacked_grads)

WORLDS = (1, 2)
TOL = dict(rtol=1e-5, atol=1e-6)


def ref_steps(model: str, tree: dict, world: int, sharded: bool, bound: int,
              compression: str = "int8", opt_name: str = "sgd",
              steps: int = 2) -> dict:
    """The reference's make_train_step on the given gradients: the
    port-named parameters after ``steps`` steps."""
    mesh = ref_mesh(world)
    opt = REF_OPTS[opt_name]()

    def loss_fn(params, batch, rng):
        leaves = jax.tree_util.tree_leaves(params)
        grads = jax.tree_util.tree_leaves(batch)
        return sum((p * g[0]).sum() for p, g in zip(leaves, grads)), {}

    step = ref_dp.make_train_step(
        loss_fn, opt, mesh, donate=False,
        compression=getattr(RefCompression, compression),
        sharded_update=sharded, bucket_bytes=bound)
    params = ref_dp.replicate(tree, mesh)
    state = ref_zero.sharded_opt_init(opt, tree, mesh, bucket_bytes=bound) \
        if sharded else ref_dp.replicate(opt.init(tree), mesh)
    for k in range(steps):
        out = step(params, state, ref_dp.shard_batch(
            stacked_grads(tree, model, world, k, compression == "int8"),
            mesh), jax.random.key(0))
        params, state = out.params, out.opt_state
    return {n: v.numpy() for n, v in cases.from_flax(
        model, jax.tree_util.tree_map(np.asarray, params)).items()}


@pytest.fixture(scope="module")
def trees():
    return {m: ref_params(m) for m in cases.LAYOUT_MODELS + ("mnist",)}


@pytest.fixture(scope="module")
def port(trees, tmp_path_factory):
    return {w: cases.spawn(w, tmp_path_factory.mktemp(f"layout{w}"),
                           "layout", (trees,), mesh=cases.MESHES[w],
                           timeout=300) for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("step", sorted(cases.LAYOUT_STEPS))
@pytest.mark.parametrize("model", cases.LAYOUT_MODELS)
def test_int8_step_matches_reference_layout(trees, port, model, step,
                                            world):
    sharded, bound = cases.LAYOUT_STEPS[step]
    want = ref_steps(model, trees[model], world, sharded, bound)
    start = {n: v.numpy() for n, v in cases.from_flax(
        model, trees[model]).items()}
    # one int8 level of the update: the tolerance must sit far below it
    level = max(np.max(np.abs(want[n] - start[n])) for n in want) / 127
    assert TOL["atol"] < level / 10
    for out in port[world]:
        got = {n: out[f"{model}|{step}|{n}"] for n in want}
        bad, total, worst = cases.int8_mismatches(got, want, TOL)
        # all but the rare one-level flips of XLA's rounding; a block
        # layout other than the reference's moves nearly every element
        assert bad <= max(2, cases.INT8_FLIP_RATE * total), (bad, total)
        assert worst <= 2 * level, (worst, level)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("sharded", [False, True])
def test_unused_parameter_is_decayed_like_optax_adamw(trees, port, world,
                                                      sharded):
    want = ref_steps("mnist", trees["mnist"], world, sharded, 0,
                     compression="none", opt_name="adamw")
    unused = cases.ZERO_KEY["mnist"]
    start = cases.from_flax("mnist", trees["mnist"])[unused].numpy()
    for out in port[world]:
        for n, w in want.items():
            np.testing.assert_allclose(out[f"zero_fill|{int(sharded)}|{n}"],
                                       w, err_msg=n, **TOL)
        # no gradient: two steps of weight decay alone
        got = out[f"zero_fill|{int(sharded)}|{unused}"]
        decay = (1 - cases.DOPT_LR["adamw"] * cases.DOPT_WD) ** 2
        np.testing.assert_allclose(got, start * decay, **TOL)


@pytest.mark.parametrize("model", ["gpt", "bert", "mnist", "resnet"])
def test_reference_layout_is_the_flax_flattening(trees, model):
    """The tagged order is jax's leaf order of the flax tree, and every
    tensor laid out as the layout says holds the flax leaf's elements in
    the flax order."""
    tree = trees[model]
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    net = cases.port_model(model)
    net.load_state_dict(cases.from_flax(model, tree), strict=False)
    params = list(net.parameters())
    layout = reference_layout(params)
    assert [params[i].flax_leaf[0] for i in layout.order] == \
        [tuple(k.key for k in path) for path, _ in leaves]
    for i, (_, leaf) in zip(layout.order, leaves):
        got = layout.to_ref(i, params[i].detach()).reshape(-1).numpy()
        np.testing.assert_array_equal(got, np.asarray(leaf).reshape(-1))
        back = layout.from_ref(i, layout.to_ref(i, params[i]))
        assert back.shape == params[i].shape


def test_untagged_parameters_keep_their_order():
    params = [torch.nn.Parameter(torch.ones(3, 2)) for _ in range(3)]
    layout = reference_layout(params)
    assert layout.order == (0, 1, 2) and layout.kinds == (None,) * 3
    params[1].flax_leaf = (("a",), "dense")
    assert reference_layout(params).order == (0, 1, 2)


def test_convert_tables_cover_the_models():
    """Every parameter of every model is a leaf of its table, once."""
    for model in ("gpt", "bert", "mnist", "resnet"):
        net = cases.port_model(model)
        names = [n for n, _ in net.named_parameters()]
        assert all(hasattr(p, "flax_leaf") for p in net.parameters())
        paths = [p.flax_leaf[0] for p in net.parameters()]
        assert len(set(paths)) == len(names)
    assert {k for _, k, _ in convert.mnist_entries()} == {
        n for n, _ in cases.port_model("mnist").named_parameters()}
