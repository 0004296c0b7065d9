"""The bucketed gradient exchange of the port (``parallel/bucketing.py``,
``make_train_step(bucket_bytes=)``): the plan against the reference's
``plan_buckets`` on the same shapes, and the contract of the reference's
tests/test_bucketed.py on the port's own steps, at world 1 in process and
at world 2 as two gloo ranks: the plain and bf16 wires give the unbucketed
step's bits for every bound, replicated and ZeRO-1; int8 gives the same
bits for every bound; a tied embedding and a parameter without a gradient
(the tiny GPT with an unused parameter) and ``remat`` change nothing; and
buckets are launched from the gradient hooks before the backward ends."""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.parallel import bucketing as ref_bucketing
from horovod_tpu_torch.parallel import bucketing

import torch_dist_cases as cases

# (shapes, dtypes) of the plan cases; dtype None is float32
PLANS = [
    ([(100,), (10,), (100,)], None),
    ([(4,), (10_000,), (4,)], None),
    ([(17, 33), (33,), (33, 65), (65,), (65, 10)], None),
    ([(8, 3), (5,), (7, 7), (2,), (300,)], ("float32", "bfloat16",
                                            "float32", "float16",
                                            "bfloat16")),
]
BOUNDS = (0, 1, 64, 460, 4096, 1 << 30)


@pytest.mark.parametrize("case", range(len(PLANS)))
@pytest.mark.parametrize("bound", BOUNDS)
def test_plan_buckets_matches_reference(case, bound):
    import jax.numpy as jnp
    shapes, dtypes = PLANS[case]
    dtypes = dtypes or ("float32",) * len(shapes)
    ref = ref_bucketing.plan_buckets(
        [jnp.zeros(s, getattr(jnp, d)) for s, d in zip(shapes, dtypes)],
        bound)
    got = bucketing.plan_buckets(
        [torch.zeros(s, dtype=getattr(torch, d))
         for s, d in zip(shapes, dtypes)], bound)
    assert [tuple(b) for b in got] == [tuple(b) for b in ref]


def test_resolve_bucket_bytes_env_default(monkeypatch):
    monkeypatch.setenv("HOROVOD_BUCKET_BYTES", "12345")
    assert bucketing.resolve_bucket_bytes(None) == 12345
    assert bucketing.resolve_bucket_bytes(7) == 7
    monkeypatch.delenv("HOROVOD_BUCKET_BYTES")
    assert bucketing.resolve_bucket_bytes(None) == 0
    assert bucketing.resolve_bucket_bytes(-3) == 0


def test_bucketed_apply_matches_reference():
    """``bucketed_apply`` against the reference's ``bucketed_apply_tree``
    with an elementwise function, padded (align 4) and not."""
    import jax.numpy as jnp
    rng = np.random.RandomState(3)
    xs = [rng.randn(10).astype(np.float32), rng.randn(2, 3).astype(np.float32),
          rng.randint(-5, 5, 5).astype(np.int32)]
    for align in (1, 4):
        want = ref_bucketing.bucketed_apply_tree(
            lambda v: v * 2 + 1, [jnp.asarray(x) for x in xs],
            bucket_bytes=16, align=align)
        got = bucketing.bucketed_apply(lambda v: v * 2 + 1,
                                       [torch.tensor(x) for x in xs],
                                       bucket_bytes=16, align=align)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_make_train_step_reads_the_env_bound(monkeypatch):
    from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
    from horovod_tpu_torch.parallel import dp
    model = GptDecoder(dtype=torch.float32, **cases.GPT_CFG)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    hvd.init(device="cpu")
    try:
        monkeypatch.setenv("HOROVOD_BUCKET_BYTES", str(1 << 16))
        want = len(bucketing.plan_buckets(list(model.parameters()),
                                          1 << 16))
        step = dp.make_train_step(model, lm_loss, opt, device="cpu")
        assert len(step.exchange.units) == want > 1
        monkeypatch.delenv("HOROVOD_BUCKET_BYTES")
        step = dp.make_train_step(model, lm_loss, opt, device="cpu")
        assert len(step.exchange.units) == 1
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def world1():
    hvd.init(device="cpu")
    try:
        return [cases.run_bucketing(0, 1, cases.gpt_state())]
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return cases.spawn(2, tmp_path_factory.mktemp("bucketing2"),
                       "bucketing", (cases.gpt_state(),), timeout=300)


def run_keys(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def params_of(out, wire, sharded, bound):
    return {k: v for k, v in
            run_keys(out, f"{wire}|{int(sharded)}|{bound}|").items()
            if k.startswith("param/")}


def assert_same_bits(a, b, what):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("wire", ["none", "bf16"])
@pytest.mark.parametrize("sharded", [False, True])
def test_bucketed_step_is_bit_exact(world, wire, sharded, request):
    """Plain and bf16 wire: every bound gives the unbucketed step's
    params and losses, bit for bit (the collectives are elementwise)."""
    outs = request.getfixturevalue(f"world{world}")
    for out in outs:
        legacy = params_of(out, wire, sharded, 0)
        for bound in cases.BUCKET_BOUNDS[1:]:
            assert_same_bits(params_of(out, wire, sharded, bound), legacy,
                             f"{wire} sharded={sharded} bound={bound}")
            np.testing.assert_array_equal(
                out[f"{wire}|{int(sharded)}|{bound}|losses"],
                out[f"{wire}|{int(sharded)}|0|losses"])


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("sharded", [False, True])
def test_bucketed_int8_is_partition_invariant(world, sharded, request):
    """int8: every bucket bound gives the same bits (tensors padded to
    whole blocks); the unbucketed layout, whose blocks span tensors, stays
    within the quantization error of the plain step."""
    outs = request.getfixturevalue(f"world{world}")
    for out in outs:
        many = params_of(out, "int8", sharded, 4096)
        assert_same_bits(many, params_of(out, "int8", sharded, 1 << 30),
                         f"int8 sharded={sharded}")
        exact = params_of(out, "none", sharded, 0)
        for k, v in params_of(out, "int8", sharded, 0).items():
            np.testing.assert_allclose(v, exact[k], rtol=0.05, atol=0.05)
            np.testing.assert_allclose(many[k], exact[k], rtol=0.05,
                                       atol=0.05)


@pytest.mark.parametrize("world", [1, 2])
def test_buckets_launch_before_the_backward_ends(world, request):
    """With a bound, units are launched from the gradient hooks before the
    last hook fires; without one, the single unit goes after the
    backward. The unused parameter gets no gradient (it stays 1 on the
    replicated path) and the step still completes."""
    for out in request.getfixturevalue(f"world{world}"):
        for wire in cases.BUCKET_WIRES:
            for sharded in (0, 1):
                key = f"{wire}|{sharded}|"
                assert out[key + "0|early"] == 0
                assert out[key + "0|units"] == 1
                assert 0 < out[key + "4096|early"] < out[key + "4096|units"]
                assert out[key + f"{1 << 30}|units"] == 1
            np.testing.assert_array_equal(
                out[f"{wire}|0|4096|param/unused"], np.ones(5))


@pytest.mark.parametrize("world", [1, 2])
def test_bucketed_remat_is_bit_exact(world, request):
    for out in request.getfixturevalue(f"world{world}"):
        assert_same_bits(
            {k: v for k, v in run_keys(out, "remat|").items()
             if k.startswith("param/")},
            params_of(out, "none", False, 4096), "remat")


def test_world2_replicas_agree(world2):
    for key, value in world2[0].items():
        np.testing.assert_array_equal(world2[1][key], value, err_msg=key)
