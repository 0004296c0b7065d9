"""ZeRO-1 (``parallel/zero.py``, ``make_train_step(sharded_update=True)``)
and the int8 wire (``compression.py``, the quantized collectives), against
the reference: the quantizer's payloads and scales bit for bit,
``quantized_allreduce`` against shard_map within the reference's own bound,
the flat-group geometry, the byte formulas, and the reference's
tests/test_zero_sharding.py contract on the port's steps at worlds 2 and 4
(gloo): sharded equals replicated within rtol 1e-5 after 3 steps with
SGD-momentum and Adam (and the reference's sharded step), the state is 1/N,
the stateful sharded step trains, the int8 step (replicated and ZeRO-1,
unbucketed and bucketed) matches the reference's int8 step, bf16 rides
both phases."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu.jax.compression import Compression as RefCompression
from horovod_tpu.jax.compression import block_quantize_rows as ref_quantize
from horovod_tpu.parallel import collectives as rc
from horovod_tpu.parallel import dp as ref_dp
from horovod_tpu.parallel import mesh as mesh_lib
from horovod_tpu.parallel import zero as ref_zero
from horovod_tpu_torch.compression import (Compression, block_dequantize_rows,
                                           block_quantize_rows)
from horovod_tpu_torch.parallel import zero

import torch_dist_cases as cases

WORLDS = (2, 4)
MESH = {2: (2, 1), 4: (2, 2)}
SHARDED = dict(rtol=1e-5, atol=1e-7)
# torch's Adam and optax's adam order their fp32 operations differently:
# across the frameworks an element near zero may differ by 1e-4 of lr
ACROSS = dict(rtol=1e-5, atol=1e-6)


def quant_rows():
    rs = np.random.RandomState(3)
    return np.concatenate([rs.randn(2, 512) * 10.0, np.zeros((2, 512)),
                           rs.randn(1, 512) * 1e-3]).astype(np.float32)


def test_block_quantize_matches_reference_bit_for_bit():
    rows = quant_rows()
    payload, scales = block_quantize_rows(torch.tensor(rows), 256)
    want_p, want_s = ref_quantize(jnp.asarray(rows), 256)
    assert payload.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(payload.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_s))


def test_int8_roundtrip_error_bound():
    """Round-trip error within scale / 2 = max|block| / 254; zero blocks
    exact (reference test_int8_roundtrip_error_bound)."""
    rows = quant_rows()
    back = block_dequantize_rows(
        *block_quantize_rows(torch.tensor(rows), 256), 256).numpy()
    amax = np.max(np.abs(rows.reshape(5, 2, 256)), axis=-1)
    bound = np.repeat(amax / 254.0 + 1e-8, 256, axis=-1).reshape(5, 512)
    assert np.all(np.abs(back - rows) <= bound)
    np.testing.assert_array_equal(back[2:4], 0.0)


def test_int8_compressor_matches_reference():
    x = np.random.RandomState(4).randn(7, 45).astype(np.float32)
    payload, ctx = Compression.int8.compress(torch.tensor(x))
    want_p, want_ctx = RefCompression.int8.compress(jnp.asarray(x))
    np.testing.assert_array_equal(payload.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(ctx[1].numpy(), np.asarray(want_ctx[1]))
    back = Compression.int8.decompress(payload, ctx)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(RefCompression.int8.decompress(want_p,
                                                                want_ctx)))
    assert Compression.int8.quantized and Compression.int8.block_size == 256
    ints = torch.arange(5)
    assert Compression.int8.decompress(*Compression.int8.compress(ints)) \
        is ints


def leaves_of(shapes, dtypes):
    return ([torch.zeros(s, dtype=getattr(torch, d))
             for s, d in zip(shapes, dtypes)],
            [jnp.zeros(s, getattr(jnp, d)) for s, d in zip(shapes, dtypes)])


GEOMETRY = ([(17, 33), (33,), (33, 65), (65,), (65, 10), (3, 3)],
            ("float32",) * 5 + ("bfloat16",))


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("bound", [0, 4096])
def test_group_geometry_matches_reference(n, bound):
    got, want = leaves_of(*GEOMETRY)
    g_groups, align = zero.plan_groups(got, n, bound)
    if bound:
        w_groups = ref_zero.bucket_groups(want, n, bound, ref_zero.LANE)
    else:
        w_groups = ref_zero._group_leaves(want, n)
    assert align == (zero.LANE if bound else 1)
    assert len(g_groups) == len(w_groups) > 0
    for g, w in zip(g_groups, w_groups):
        assert (g.key, g.indices, g.sizes, g.padded, g.shard) == \
            (w.key, w.indices, w.sizes, w.padded, w.shard)
        assert [tuple(s) for s in g.shapes] == [tuple(s) for s in w.shapes]


def test_byte_formulas_match_reference():
    for mode in ("allreduce", "sharded"):
        for wire in (4.0, 2.0, 1.0):
            assert zero.collective_bytes_per_step(
                int(25.6e6), 8, mode=mode, wire_bytes_per_elem=wire) == \
                ref_zero.collective_bytes_per_step(
                    int(25.6e6), 8, mode=mode, wire_bytes_per_elem=wire)
    with pytest.raises(ValueError):
        zero.collective_bytes_per_step(10, 2, mode="banana")
    got, want = leaves_of([(1000, 1003), (7,)], ("float32", "float32"))
    for n in (1, 4, 8):
        assert zero.optimizer_state_bytes(got, n) == \
            ref_zero.optimizer_state_bytes(want, n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {w: cases.spawn(w, tmp_path_factory.mktemp(f"zero{w}"), "zero",
                           mesh=MESH[w], timeout=300) for w in WORLDS}


def odd_params_ref():
    rs = np.random.RandomState(0)
    return {"scalar": jnp.asarray(0.7, jnp.float32),
            "vec": jnp.asarray(rs.randn(13), jnp.float32),
            "mat": jnp.asarray(rs.randn(5, 7), jnp.float32),
            "deep": {"w": jnp.asarray(rs.randn(3, 11), jnp.float32)}}


def ref_quadratic_loss(params, batch, rng):
    total = sum(jnp.sum(leaf ** 2) for leaf in
                jax.tree_util.tree_leaves(params))
    pred = batch["x"] * params["scalar"]
    return jnp.mean((pred - batch["y"]) ** 2) + 0.01 * total, {}


REF_OPTS = {"sgd_momentum": lambda: optax.sgd(0.1, momentum=0.9),
            "adam": lambda: optax.adam(1e-2)}


def ref_odd_params(world, opt_name, steps, sharded_update=True,
                   bucket_bytes=0, **kw):
    """The reference's step of the odd-sized parameters, ``steps`` steps,
    as ``{OddParams name: array}`` and the last loss."""
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=MESH[world][0],
                                                 fsdp=MESH[world][1]),
                               jax.devices()[:world])
    opt = REF_OPTS[opt_name]()
    params = odd_params_ref()
    step = ref_dp.make_train_step(ref_quadratic_loss, opt, mesh,
                                  donate=False, sharded_update=sharded_update,
                                  bucket_bytes=bucket_bytes, **kw)
    p = ref_dp.replicate(params, mesh)
    s = ref_zero.sharded_opt_init(opt, params, mesh,
                                  bucket_bytes=bucket_bytes) \
        if sharded_update else ref_dp.replicate(opt.init(params), mesh)
    batch = ref_dp.shard_batch({k: jnp.asarray(v)
                                for k, v in cases.odd_batch().items()}, mesh)
    for _ in range(steps):
        out = step(p, s, batch, jax.random.key(0))
        p, s = out.params, out.opt_state
    flat = {"scalar": p["scalar"], "vec": p["vec"], "mat": p["mat"],
            "deep_w": p["deep"]["w"]}
    return {k: np.asarray(v) for k, v in flat.items()}, float(out.loss)


def ref_sharded_params(world, opt_name):
    """The reference's sharded step, 3 steps."""
    return ref_odd_params(world, opt_name, 3)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("opt_name", ["sgd_momentum", "adam"])
def test_sharded_matches_replicated(runs, world, opt_name):
    """The acceptance gate of the reference's test_sharded_matches_
    replicated on the port: 3 steps over an odd-sized parameter set,
    sharded against replicated within rtol 1e-5, and against the
    reference's sharded step."""
    want, want_loss = ref_sharded_params(world, opt_name)
    for out in runs[world]:
        rep = f"{opt_name}|0|"
        sh = f"{opt_name}|1|"
        np.testing.assert_allclose(out[sh + "losses"][-1],
                                   out[rep + "losses"][-1], rtol=1e-5)
        np.testing.assert_allclose(out[sh + "losses"][-1], want_loss,
                                   rtol=1e-5)
        for name in cases.ODD_KEYS:
            got = out[f"{sh}param/{name}"]
            np.testing.assert_allclose(got, out[f"{rep}param/{name}"],
                                       err_msg=name, **SHARDED)
            np.testing.assert_allclose(got, want[name], err_msg=name,
                                       **ACROSS)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_state_is_one_nth(runs, world):
    """Adam's state on the shards is 1/N of the replicated state, up to
    the padding of each group to N * LANE."""
    n_params = 1 + 13 + 35 + 33
    for out in runs[world]:
        rep = int(out["adam|0|state_bytes"])
        sh = int(out["adam|1|state_bytes"])
        padded = n_params + (-n_params) % (world * zero.LANE)
        assert sh == 2 * 4 * padded // world + 4  # two moments and a step
        assert rep == 2 * 4 * n_params + 4 * 4


@pytest.mark.parametrize("world", WORLDS)
def test_int8_sharded_training_converges_and_stays_replicated(runs, world):
    outs = runs[world]
    for out in outs:
        losses = out["int8_sharded|losses"]
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    for key, value in outs[0].items():
        np.testing.assert_array_equal(outs[-1][key], value, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(cases.INT8_STEPS))
def test_int8_step_matches_reference(runs, world, name):
    """The int8 step, replicated and ZeRO-1, unbucketed and in three
    buckets, against the reference's make_train_step with Compression.int8
    on the same inputs: what crosses the wire (the gradient, then on the
    sharded path each shard's update), the block layout of each unit and
    the scaling after the reduce-scatter all match, so the parameters
    agree to fp32 rounding. The tolerance is far below one int8 level of
    the step's update (max |update| / 127), which a wrong shard, block or
    scale would exceed."""
    sharded, bound = cases.INT8_STEPS[name]
    want, want_loss = ref_odd_params(
        world, cases.INT8_STEP_OPT, cases.INT8_STEP_COUNT,
        sharded_update=sharded, bucket_bytes=bound,
        compression=RefCompression.int8)
    start = cases.OddParams()
    level = max(float(np.max(np.abs(want[n] - p.detach().numpy())))
                for n, p in start.named_parameters()) / 127.0
    tol = dict(rtol=1e-5, atol=1e-6)
    assert tol["atol"] < level / 100
    for out in runs[world]:
        np.testing.assert_allclose(out[f"{name}|losses"][-1], want_loss,
                                   rtol=1e-5)
        for n in cases.ODD_KEYS:
            np.testing.assert_allclose(out[f"{name}|param/{n}"], want[n],
                                       err_msg=n, **tol)


@pytest.mark.parametrize("world", WORLDS)
def test_lossy_wires_stay_close_to_the_exact_step(runs, world):
    """int8 on the replicated path and bf16 on both sharded phases, one
    SGD step, within the 16-bit / int8 tolerance of the exact step
    (reference test_int8_allreduce_path_in_train_step,
    test_sharded_bf16_wire_both_phases)."""
    for out in runs[world]:
        for name in cases.ODD_KEYS:
            for lossy, exact in (("int8", "exact"),
                                 ("bf16_sharded", "exact_sharded")):
                np.testing.assert_allclose(
                    out[f"{lossy}|param/{name}"],
                    out[f"{exact}|param/{name}"], rtol=5e-2, atol=5e-3)
            np.testing.assert_allclose(out[f"exact_sharded|param/{name}"],
                                       out[f"exact|param/{name}"],
                                       **SHARDED)


@pytest.mark.parametrize("world", WORLDS)
def test_stateful_sharded_step(runs, world):
    """make_stateful_train_step(sharded_update=True) trains, and matches the
    replicated stateful step (BatchNorm statistics included)."""
    for out in runs[world]:
        losses = out["stateful|1|losses"]
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
        for key in out:
            if key.startswith("stateful|1|") and "losses" not in key:
                np.testing.assert_allclose(
                    out[key], out[key.replace("|1|", "|0|")], err_msg=key,
                    **SHARDED)


@pytest.mark.parametrize("world", WORLDS)
def test_quantized_allreduce_matches_reference(runs, world):
    """The port's quantized_allreduce against the reference's under
    shard_map, and both against the exact average within the reference's
    two-round-trip bound (test_quantized_allreduce_close_to_exact), over
    the replica axes in either order."""
    vals = cases.quant_input(world)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=MESH[world][0],
                                                 fsdp=MESH[world][1]),
                               jax.devices()[:world])
    bound = 2 * np.max(np.abs(vals)) / 127.0
    exact = vals.mean(0)
    for axis in (("data", "fsdp"), ("fsdp", "data")):
        want = np.asarray(jax.jit(jax.shard_map(
            lambda v: rc.quantized_allreduce(v[0], op=rc.Average,
                                             axis=axis),
            mesh=mesh, in_specs=(P(("data", "fsdp")),), out_specs=P(),
            check_vma=False))(jnp.asarray(vals)))
        assert np.max(np.abs(want - exact)) <= bound
        for out in runs[world]:
            got = out[f"quant|{cases.axis_tag(axis)}"]
            assert np.max(np.abs(got - exact)) <= bound
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
