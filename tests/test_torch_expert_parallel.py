"""The port's expert parallelism against the reference's: top1_dispatch's
positions and capacity exactly (first maximum on ties, as jnp.argmax), and
moe_layer under shard_map on a CPU mesh of the same size at worlds 2 and 4
(gloo processes over ``expert``, two experts per rank): the forward with
room for every token, over-capacity drops (exact zero rows), the
gradients of sum(out^2) for the gate (this rank's own), the local expert
weights and the tokens; and the wrong gate width. Tolerances are the
reference tests' (rtol 2e-4 / atol 2e-5; gradients 2e-3 / 2e-4)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.parallel import mesh as mesh_lib
from horovod_tpu.parallel.ep import moe_layer, top1_dispatch

import torch_dist_cases as cases

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)
EXPERT = P("expert")


@functools.lru_cache(maxsize=None)
def reference(world: int, case: str) -> dict:
    """The reference's moe_layer output [world, T_local, D] and, for
    "grad", every rank's gradients (w_gate's per rank, unreduced)."""
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=1, expert=world),
                               jax.devices()[:world])
    a = {k: jnp.asarray(v) for k, v in cases.ep_inputs(world, case).items()}
    cf = cases.EP_CASES[case][1] or float(world * cases.EP_DIMS["e_loc"])

    def local(x, w_gate, w_in, w_out):
        def fwd(x, w_gate, w_in, w_out):
            return moe_layer(x[0], w_gate, w_in, w_out, capacity_factor=cf)
        out, vjp = jax.vjp(fwd, x, w_gate, w_in, w_out)
        dx, dg, di, do = vjp(2 * out)  # the gradients of sum(out^2)
        return out[None], dx, dg[None], di, do
    mapped = jax.shard_map(
        local, mesh=mesh, in_specs=(EXPERT, P(), EXPERT, EXPERT),
        out_specs=(EXPERT,) * 5, check_vma=False)
    outs = jax.jit(mapped)(a["x"], a["w_gate"], a["w_in"], a["w_out"])
    keys = ("out", "grad|dx", "grad|dw_gate", "grad|dw_in", "grad|dw_out")
    return {k: np.asarray(o) for k, o in zip(keys, outs)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return cases.spawn(2, tmp_path_factory.mktemp("ep2"), "ep",
                       mesh={"data": 1, "expert": 2})


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return cases.spawn(4, tmp_path_factory.mktemp("ep4"), "ep",
                       mesh={"data": 1, "expert": 4})


def test_top1_dispatch_positions_and_capacity():
    """The reference test's example, then random gates with ties: the
    same one-hots bit for bit."""
    from horovod_tpu_torch.parallel import ep
    gates = np.asarray([[0.9, 0.1], [0.8, 0.2], [0.7, 0.3], [0.2, 0.8]],
                       np.float32)
    dispatch, combine = ep.top1_dispatch(torch.tensor(gates), capacity=2)
    assert dispatch[0, 0, 0] == 1 and dispatch[1, 0, 1] == 1
    assert float(dispatch[2].sum()) == 0.0
    assert dispatch[3, 1, 0] == 1
    assert abs(float(combine[0].sum()) - 0.9) < 1e-6
    rng = np.random.RandomState(5)
    for t, e, cap in ((16, 4, 3), (64, 8, 5), (33, 3, 20)):
        g = rng.randint(0, 4, (t, e)).astype(np.float32)  # many ties
        got = [x.numpy() for x in ep.top1_dispatch(torch.tensor(g), cap)]
        want = [np.asarray(x) for x in top1_dispatch(jnp.asarray(g), cap)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["fwd", "drop", "grad"])
def test_moe_layer_matches_reference(world, case, request):
    outs = request.getfixturevalue(f"world{world}")
    want = reference(world, case)
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out[case], want["out"][rank], **FWD,
                                   err_msg=f"{case} rank {rank}")
    if case == "drop":
        rows = np.concatenate([out["drop"] for out in outs])
        assert np.isfinite(rows).all()
        zero = np.abs(rows).sum(-1) == 0
        assert zero.any()
        np.testing.assert_array_equal(
            zero, np.abs(want["out"]).sum(-1).reshape(-1) == 0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("key", ["dx", "dw_gate", "dw_in", "dw_out"])
def test_moe_layer_gradients_match_reference(world, key, request):
    outs = request.getfixturevalue(f"world{world}")
    want = reference(world, "grad")[f"grad|{key}"]
    for rank, out in enumerate(outs):
        w = want[rank] if key == "dw_gate" else \
            np.split(want, world)[rank]
        got = out[f"grad|{key}"]
        np.testing.assert_allclose(got, w.reshape(got.shape), **GRAD,
                                   err_msg=f"{key} rank {rank}")
        assert np.abs(got).sum() > 0


def test_moe_layer_rejects_wrong_gate_width():
    from horovod_tpu_torch.parallel import ep
    hvd.init(device="cpu")
    try:
        d, e_loc = cases.EP_DIMS["d"], cases.EP_DIMS["e_loc"]
        w_in = torch.zeros(e_loc, d, 4)
        w_out = torch.zeros(e_loc, 4, d)
        with pytest.raises(ValueError, match="routes to"):
            ep.moe_layer(torch.zeros(4, d), torch.zeros(d, e_loc + 1),
                         w_in, w_out)
    finally:
        hvd.shutdown()
