"""One data-parallel train step of the tiny GPT in the port
(``make_train_step`` with ``torch.optim.AdamW``) against the reference
(``dp.make_train_step`` with ``optax.adamw``) from the same weights on the
same tokens: loss, params and both AdamW moments. World 1 runs in process on
a 1-device reference mesh; world 2 spawns two gloo processes and compares
with a 2-device reference mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.jax.compression import Compression as RefCompression
from horovod_tpu.models.gpt import GptDecoder as RefGpt
from horovod_tpu.parallel import dp as ref_dp
from horovod_tpu.parallel import mesh as mesh_lib
from horovod_tpu_torch.models.convert import from_flax_params

import torch_dist_cases as cases

T = 128
# Moments are linear (mu) or quadratic (nu) in the gradients: gradient
# tolerances. A first AdamW step moves a param by lr * g/(|g|+eps), about
# lr per element: where |g| is well above eps the tolerance is the gradient
# one scaled by lr. Gradients that are zero in exact arithmetic (the key
# bias: softmax ignores a per-query constant) come out as rounding noise
# near eps in both frameworks, and g/(|g|+eps) of noise is any number in
# [-1, 1]: there only the bound |update| <= lr holds for both.
MU = dict(rtol=2e-3, atol=2e-4 * 0.1)
NU = dict(rtol=4e-3, atol=1e-8)
PARAM = dict(rtol=1e-5, atol=2e-3 * cases.LR)
MEANINGFUL_GRAD = 1e-6  # 100x AdamW's eps


@pytest.fixture(autouse=True)
def _flash_from_64(monkeypatch):
    monkeypatch.setenv("HOROVOD_FLASH_MIN_SEQ", "64")


def setup(batch):
    ref = RefGpt(dtype=jnp.float32, **cases.GPT_CFG)
    params = ref.init(jax.random.key(0), jnp.zeros((2, T), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    tokens = np.random.RandomState(1).randint(
        0, cases.GPT_CFG["vocab"], (batch, T)).astype(np.int64)
    return ref, params, tokens


def ref_step(ref, params, tokens, world, compression):
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=world),
                               jax.devices()[:world])
    opt = optax.adamw(cases.LR)

    def loss_fn(p, batch, rng):
        logits = ref.apply({"params": p}, batch)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], batch[:, 1:]).mean(), {}

    step = ref_dp.make_train_step(
        loss_fn, opt, mesh, donate=False,
        compression=getattr(RefCompression, compression))
    out = step(ref_dp.replicate(params, mesh),
               ref_dp.replicate(opt.init(params), mesh),
               ref_dp.shard_batch(jnp.asarray(tokens, jnp.int32), mesh),
               jax.random.key(0))
    adam = out.opt_state[0]
    res = {"loss": np.asarray(out.loss)}
    for prefix, tree in (("param", out.params), ("mu", adam.mu),
                         ("nu", adam.nu)):
        sd = from_flax_params(jax.tree_util.tree_map(np.asarray, tree))
        res.update({f"{prefix}/{k}": v.numpy() for k, v in sd.items()})
    return res


def assert_step_matches(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-4,
                               atol=2e-5)
    names = [k[len("param/"):] for k in want if k.startswith("param/")]
    assert sorted(names) == sorted(k[len("param/"):] for k in got
                                   if k.startswith("param/"))
    for name in names:
        for prefix, tol in (("mu", MU), ("nu", NU)):
            key = f"{prefix}/{name}"
            np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                       **tol)
        # mu = (1 - b1) g after one step
        real = np.abs(want[f"mu/{name}"]) / 0.1 > MEANINGFUL_GRAD
        key = f"param/{name}"
        np.testing.assert_allclose(got[key][real], want[key][real],
                                   err_msg=key, **PARAM)
        assert np.all(np.abs(got[key] - want[key]) <= 2.01 * cases.LR), key


@pytest.mark.parametrize("compression", ["none", "bf16"])
def test_dp_step_world1_matches_reference(compression):
    ref, params, tokens = setup(batch=2)
    want = ref_step(ref, params, tokens, 1, compression)
    state = {k: v.numpy() for k, v in from_flax_params(params).items()}
    hvd.init(device="cpu")
    try:
        got = cases.run_dp_step(0, 1, state, tokens, compression)
    finally:
        hvd.shutdown()
    assert_step_matches(got, want)


@pytest.mark.parametrize("compression", ["none", "bf16"])
def test_dp_step_world2_matches_reference(compression, tmp_path):
    """Two gloo ranks, each on its half of the batch (bf16 compression runs
    its allreduce in bf16 on gloo)."""
    ref, params, tokens = setup(batch=4)
    want = ref_step(ref, params, tokens, 2, compression)
    state = {k: v.numpy() for k, v in from_flax_params(params).items()}
    outs = cases.spawn(2, tmp_path, "dp", (state, tokens, compression))
    for got in outs:
        assert_step_matches(got, want)


def test_remat_gives_the_same_step():
    _, params, tokens = setup(batch=2)
    state = {k: v.numpy() for k, v in from_flax_params(params).items()}
    from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
    from horovod_tpu_torch.parallel import dp
    hvd.init(device="cpu")
    try:
        results = []
        for remat in (False, True):
            model = GptDecoder(dtype=torch.float32, **cases.GPT_CFG)
            model.load_state_dict({k: torch.tensor(v)
                                   for k, v in state.items()})
            opt = torch.optim.AdamW(model.parameters(), lr=cases.LR)
            step = dp.make_train_step(model, lm_loss, opt, remat=remat,
                                      device="cpu")
            out = step(torch.tensor(tokens))
            results.append((out.loss, [p.detach().clone()
                                       for p in model.parameters()]))
        assert torch.equal(results[0][0], results[1][0])
        for a, b in zip(results[0][1], results[1][1]):
            assert torch.equal(a, b)
    finally:
        hvd.shutdown()


def test_aux_leaves_are_synced_and_unported_options_raise():
    """Aux leaves are synced; the slice-5 options run, and the pairs the
    reference refuses raise its ValueErrors."""
    from horovod_tpu_torch.parallel import dp, zero
    model = torch.nn.Linear(3, 1)

    def loss_fn(m, batch):
        loss = m(batch).pow(2).mean()
        return loss, {"mean": loss.detach(), "count": torch.tensor(5),
                      "tag": "x"}

    hvd.init(device="cpu")
    try:
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        before_weight = model.weight.detach().clone()
        before_bias = model.bias.detach().clone()
        out = dp.make_train_step(model, loss_fn, opt, device="cpu")(
            torch.ones(4, 3))
        assert out.aux["count"].item() == 5 and out.aux["tag"] == "x"
        torch.testing.assert_close(out.aux["mean"], out.loss)
        sharded = zero.sharded_optimizer(
            model, lambda ps: torch.optim.SGD(ps, lr=0.1))
        for kw in (dict(sharded_update=True, optimizer=sharded),
                   dict(bucket_bytes=1 << 20), dict(op=hvd.Op.ADASUM),
                   dict(compression=hvd.Compression.int8)):
            kw.setdefault("optimizer", opt)
            ran = dp.make_train_step(model, loss_fn, device="cpu", **kw)(
                torch.ones(4, 3))
            assert torch.isfinite(ran.loss)
        for kw, match in (
                (dict(sharded_update=True, optimizer=sharded,
                      op=hvd.Op.ADASUM), "Adasum"),
                (dict(sharded_update=True, optimizer=sharded,
                      hierarchical=True), "hierarchical"),
                (dict(compression=hvd.Compression.int8, hierarchical=True),
                 "hierarchical"),
                (dict(sharded_update=True), "sharded_optimizer"),
                (dict(sharded_update=True, optimizer=sharded,
                      bucket_bytes=4096), "bucket_bytes"),
                (dict(optimizer=sharded), "sharded_update=True")):
            kw.setdefault("optimizer", opt)
            with pytest.raises(ValueError, match=match):
                dp.make_train_step(model, loss_fn, device="cpu", **kw)
        # the two-level allreduce is ported: at world 1 it is the identity
        flat = out.loss
        with torch.no_grad():
            model.weight.copy_(before_weight)
            model.bias.copy_(before_bias)
        out = dp.make_train_step(model, loss_fn, opt, device="cpu",
                                 hierarchical=True)(torch.ones(4, 3))
        torch.testing.assert_close(out.loss, flat)
        assert dp.shard_batch(torch.arange(6), rank=1, size=3).tolist() == \
            [2, 3]
        with pytest.raises(ValueError, match="divisible"):
            dp.shard_batch(torch.arange(5), rank=0, size=2)
    finally:
        hvd.shutdown()
