"""The port's tensor and pipeline parallelism against the reference's
under shard_map on a CPU mesh of the same size, at worlds 2 and 4 (gloo
processes over ``model`` or ``pipe``): tp_mlp, the column/row pair's
gradients (weights and input), tp_mlp_inference on the fp32 and int8
wires, the pipeline at n_micro 4 and 8 against the sequential model, its
gradients, bf16 activations; and at world 1 the ragged-batch refusal, the
wire-bytes arithmetic and GELU's tanh approximation. Tolerances are the
reference tests' (rtol 2e-4 / atol 2e-5; gradients 2e-3; bf16 0.05)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.jax.compression import Compression as RefCompression
from horovod_tpu.parallel import mesh as mesh_lib
from horovod_tpu.parallel import pp as ref_pp
from horovod_tpu.parallel import tp as ref_tp

import torch_dist_cases as cases

FWD = dict(rtol=2e-4, atol=2e-5)


def ref_mesh(world, axis):
    return mesh_lib.build_mesh(mesh_lib.MeshSpec(data=1, **{axis: world}),
                               jax.devices()[:world])


@functools.lru_cache(maxsize=None)
def tp_reference(world: int) -> dict:
    a = {k: jnp.asarray(v) for k, v in cases.tp_inputs().items()}
    specs = (P(), P(None, "model"), P("model", None))

    def local(x, w_in, w_out):
        def loss(w_in, w_out, x):
            y = ref_tp.row_parallel(
                jnp.tanh(ref_tp.column_parallel(x, w_in)), w_out)
            return jnp.sum(y ** 2)
        grads = jax.grad(loss, argnums=(0, 1, 2))(w_in, w_out, x)
        return (ref_tp.tp_mlp(x, w_in, w_out), *grads,
                ref_tp.tp_mlp_inference(x, w_in, w_out),
                ref_tp.tp_mlp_inference(x, w_in, w_out,
                                        compression=RefCompression.int8))
    mapped = jax.shard_map(
        local, mesh=ref_mesh(world, "model"), in_specs=specs,
        out_specs=(P(), P(None, "model"), P("model", None), P(), P(), P()),
        check_vma=False)
    outs = jax.jit(mapped)(a["x"], a["w_in"], a["w_out"])
    keys = ("mlp", "dw_in", "dw_out", "dx", "infer_fp32", "infer_int8")
    return {k: np.asarray(o) for k, o in zip(keys, outs)}


@functools.lru_cache(maxsize=None)
def pp_reference(world: int) -> dict:
    a = {k: jnp.asarray(v) for k, v in cases.pp_inputs(world).items()}
    mesh = ref_mesh(world, "pipe")

    def stage(w, h):
        return jnp.tanh(h @ w)
    out = {}
    for m in (4, 8):
        mapped = jax.shard_map(
            lambda ws, x, m=m: ref_pp.pipeline_apply(stage, ws[0], x,
                                                     n_micro=m),
            mesh=mesh, in_specs=(P("pipe"), P()), out_specs=P(),
            check_vma=False)
        out[f"fwd|{m}"] = np.asarray(jax.jit(mapped)(a["ws"], a["x"]))

    def grad_local(ws, x, y):
        def loss(w):
            o = ref_pp.pipeline_apply(stage, w, x, n_micro=4)
            return jnp.mean((o - y) ** 2)
        return jax.grad(loss)(ws[0])[None]
    mapped = jax.shard_map(grad_local, mesh=mesh,
                           in_specs=(P("pipe"), P(), P()),
                           out_specs=P("pipe"), check_vma=False)
    out["grad"] = np.asarray(jax.jit(mapped)(a["ws"], a["x_grad"], a["y"]))
    mapped = jax.shard_map(
        lambda ws, x: ref_pp.pipeline_apply(stage, ws[0], x, n_micro=4),
        mesh=mesh, in_specs=(P("pipe"), P()), out_specs=P(),
        check_vma=False)
    out["bf16"] = np.asarray(jax.jit(mapped)(
        a["ws"].astype(jnp.bfloat16), a["x_grad"].astype(jnp.bfloat16)),
        np.float32)
    # the sequential model the reference's tests hold the pipeline to
    h = a["x"]
    for i in range(world):
        h = stage(a["ws"][i], h)
    out["seq|fwd"] = np.asarray(h)
    return out


def _spawn(tmp_path_factory, job, world, axis):
    return cases.spawn(world, tmp_path_factory.mktemp(f"{job}{world}"), job,
                       mesh={"data": 1, axis: world})


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return _spawn(tmp_path_factory, "tp", 2, "model")


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    return _spawn(tmp_path_factory, "tp", 4, "model")


@pytest.fixture(scope="module")
def pp2(tmp_path_factory):
    return _spawn(tmp_path_factory, "pp", 2, "pipe")


@pytest.fixture(scope="module")
def pp4(tmp_path_factory):
    return _spawn(tmp_path_factory, "pp", 4, "pipe")


def int8_tol(want):
    """Two int8 round trips: within 2 max|y| / 127 of each other, the
    reference tests' bound (test_zero_sharding.py:165-185)."""
    return dict(rtol=0.0, atol=2 * float(np.abs(want).max()) / 127)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("key", ["mlp", "dw_in", "dw_out", "dx",
                                 "infer_fp32", "infer_int8"])
def test_tp_matches_reference(world, key, request):
    outs = request.getfixturevalue(f"tp{world}")
    want = tp_reference(world)[key]
    per = want.shape[-1 if key == "dw_in" else 0] // world
    for rank, out in enumerate(outs):
        w = want
        if key == "dw_in":
            w = want[:, rank * per:(rank + 1) * per]
        elif key == "dw_out":
            w = want[rank * per:(rank + 1) * per]
        tol = int8_tol(w) if key == "infer_int8" else FWD
        np.testing.assert_allclose(out[key], w, **tol,
                                   err_msg=f"{key} rank {rank}")


@pytest.mark.parametrize("world", [2, 4])
def test_tp_mlp_matches_dense(world, request):
    """The reference test's own check: the sharded MLP equals the dense
    MLP with GELU's tanh approximation (jax.nn.gelu's default)."""
    a = cases.tp_inputs()
    x, w_in, w_out = (torch.tensor(a[k]) for k in ("x", "w_in", "w_out"))
    want = torch.nn.functional.gelu(x @ w_in, approximate="tanh") @ w_out
    for out in request.getfixturevalue(f"tp{world}"):
        np.testing.assert_allclose(out["mlp"], want.numpy(), **FWD)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("key", ["fwd|4", "fwd|8", "grad", "bf16"])
def test_pipeline_matches_reference(world, key, request):
    outs = request.getfixturevalue(f"pp{world}")
    want = pp_reference(world)
    for rank, out in enumerate(outs):
        if key == "grad":
            np.testing.assert_allclose(out[key], want[key][rank], rtol=2e-3,
                                       atol=2e-5, err_msg=f"rank {rank}")
        elif key == "bf16":
            assert str(out["bf16_dtype"]) == "torch.bfloat16"
            np.testing.assert_allclose(out[key], want[key], rtol=0.05,
                                       atol=0.05)
        else:
            np.testing.assert_allclose(out[key], want[key], **FWD)
            np.testing.assert_allclose(out[key], want["seq|fwd"], **FWD)


def test_pipeline_rejects_ragged_microbatch():
    from horovod_tpu_torch.parallel import pp
    hvd.init(device="cpu")
    try:
        with pytest.raises(ValueError, match="divide"):
            pp.pipeline_apply(cases.pp_stage, torch.zeros(4, 4),
                              torch.zeros(10, 4), n_micro=4)
    finally:
        hvd.shutdown()


def test_world1_tp_and_pipeline_are_local():
    """At world 1 (every axis of size 1) the column/row pair is the dense
    product, its gradients the dense ones, and a one-stage pipeline the
    stage itself."""
    from horovod_tpu_torch.parallel import pp, tp
    hvd.init(device="cpu")
    try:
        a = {k: torch.tensor(v) for k, v in cases.tp_inputs().items()}
        wi = a["w_in"].clone().requires_grad_(True)
        y = tp.row_parallel(tp.column_parallel(a["x"], wi), a["w_out"])
        g, = torch.autograd.grad(y.sum(), wi)
        wi2 = a["w_in"].clone().requires_grad_(True)
        g2, = torch.autograd.grad((a["x"] @ wi2 @ a["w_out"]).sum(), wi2)
        assert torch.allclose(y, a["x"] @ a["w_in"] @ a["w_out"])
        assert torch.allclose(g, g2)
        w = torch.tensor(cases.pp_inputs(1)["ws"][0])
        x = torch.tensor(cases.pp_inputs(1)["x"])
        assert torch.equal(pp.pipeline_apply(cases.pp_stage, w, x, 4),
                           cases.pp_stage(w, x))
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_activation_wire_bytes_match_reference(world):
    from horovod_tpu_torch import Compression
    from horovod_tpu_torch.parallel import tp
    for n in (1000, 4096, 12345):
        assert tp.tp_activation_wire_bytes(n, world) == \
            ref_tp.tp_activation_wire_bytes(n, world)
        assert tp.tp_activation_wire_bytes(
            n, world, compression=Compression.int8) == \
            ref_tp.tp_activation_wire_bytes(
                n, world, compression=RefCompression.int8)


def test_default_activation_is_jax_gelu():
    """jax.nn.gelu defaults to the tanh approximation; F.gelu to erf."""
    from horovod_tpu_torch.parallel import tp
    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(tp.gelu_tanh(torch.tensor(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.tensor(x)).numpy()
    assert not np.allclose(erf, np.asarray(jax.nn.gelu(jnp.asarray(x))),
                           rtol=1e-5, atol=1e-6)
