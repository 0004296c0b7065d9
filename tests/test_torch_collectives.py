"""The port's allreduce (ops, pre/postscale, wire dtype) and fused_apply_tree
against the reference's collectives under shard_map, at world 1 (in
process) and at world 2 (two gloo processes spawned with
torch.multiprocessing against a 2-device reference mesh)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.ops.fusion import fused_apply_tree as ref_fused_tree
from horovod_tpu.parallel import collectives as rc
from horovod_tpu.parallel import mesh as mesh_lib

import torch_dist_cases as cases


def ref_mesh(n):
    return mesh_lib.build_mesh(mesh_lib.MeshSpec(data=n), jax.devices()[:n])


def run_spmd(fn, mesh, *args):
    mapped = jax.shard_map(lambda *vs: fn(*[v[0] for v in vs]), mesh=mesh,
                           in_specs=tuple(P(("data",)) for _ in args),
                           out_specs=P(), check_vma=False)
    return jax.jit(mapped)(*args)


def ref_allreduce(name, world):
    op, dtype, pre, post, acc = cases.ALLREDUCE_CASES[name]
    x = jnp.asarray(cases.case_input(name, world), getattr(jnp, dtype))
    out = run_spmd(lambda v: rc.allreduce(v, op=getattr(rc, op),
                                          prescale_factor=pre,
                                          postscale_factor=post,
                                          accumulate_in_fp32=acc),
                   ref_mesh(world), x)
    return np.asarray(out, np.float32)


def ref_tree(world):
    leaves = {k: jnp.asarray(v, getattr(jnp, cases.TREE_DTYPES[k]))
              for k, v in cases.tree_input(world).items()}

    def fn(a, b0, b1, c):
        red = ref_fused_tree(lambda v: rc.allreduce(v, op=rc.Average),
                             {"a": a, "b": [b0, b1], "c": c})
        return red["a"], red["b"][0], red["b"][1], red["c"]
    outs = run_spmd(fn, ref_mesh(world), leaves["a"], leaves["b0"],
                    leaves["b1"], leaves["c"])
    return {f"tree_{k}": np.asarray(o, np.float32)
            for k, o in zip(("a", "b0", "b1", "c"), outs)}


def assert_same(got, want, dtype):
    # same inputs, same rounding points: equal up to the last bit of the
    # dtype (a sum of two values may round once differently)
    tol = {"float32": 1e-6, "bfloat16": 8e-3, "float16": 1e-3,
           "int32": 0.0}[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield cases.run_collectives(0, 1)
    hvd.shutdown()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return cases.spawn(2, tmp_path_factory.mktemp("coll2"), "collectives")


@pytest.mark.parametrize("name", sorted(cases.ALLREDUCE_CASES))
def test_allreduce_world1_matches_reference(world1, name):
    assert_same(world1[name], ref_allreduce(name, 1),
                cases.ALLREDUCE_CASES[name][1])


@pytest.mark.parametrize("name", sorted(cases.ALLREDUCE_CASES))
def test_allreduce_world2_matches_reference(world2, name):
    want = ref_allreduce(name, 2)
    for rank_out in world2:
        assert_same(rank_out[name], want, cases.ALLREDUCE_CASES[name][1])


@pytest.mark.parametrize("world", [1, 2])
def test_fused_apply_tree_matches_reference(world, request):
    outs = [request.getfixturevalue("world1")] if world == 1 else \
        request.getfixturevalue("world2")
    want = ref_tree(world)
    for out in outs:
        for key, w in want.items():
            assert_same(out[key], w, cases.TREE_DTYPES[key[5:]])


def test_broadcast_replicate_and_axis_queries_world2(world2):
    for rank, out in enumerate(world2):
        np.testing.assert_array_equal(out["broadcast"], [8.0, 8.0, 8.0])
        np.testing.assert_array_equal(out["axis"], [rank, 2])
        np.testing.assert_array_equal(out["replicate"], np.ones((2, 2)))


def test_unported_ops_raise(world1):
    """Every op and axis is ported: Adasum at world 1 returns its input
    (Product is an allreduce case above), and an allreduce over "model",
    an axis of size 1 here, is the identity, as lax.psum over a size-1
    axis is; an unknown axis name raises."""
    from horovod_tpu_torch.parallel import collectives as c
    x = torch.tensor([1.5, -2.0])
    assert torch.equal(c.allreduce(x, op=c.Adasum), x)
    for op in (c.Sum, c.Average, c.Max):
        assert torch.equal(c.allreduce(x, op=op, axis="model"), x)
    with pytest.raises(ValueError, match="mesh axes"):
        c.allreduce(torch.ones(2), axis="tensor")


def test_mesh_spec_supports_data_axis_only():
    """Every axis resolves as in the reference, alone and with others."""
    from horovod_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec
    assert AXIS_ORDER == mesh_lib.AXIS_ORDER
    assert MeshSpec().resolve(4) == mesh_lib.MeshSpec().resolve(4)
    assert MeshSpec(data=2, fsdp=2).resolve(4) == \
        mesh_lib.MeshSpec(data=2, fsdp=2).resolve(4)
    assert MeshSpec(fsdp=4).resolve(8) == mesh_lib.MeshSpec(fsdp=4).resolve(8)
    for axis in ("model", "seq", "pipe", "expert"):
        assert MeshSpec(data=2, **{axis: 2}).resolve(4) == \
            mesh_lib.MeshSpec(data=2, **{axis: 2}).resolve(4)
        assert MeshSpec(data=-1, **{axis: 4}).resolve(8) == \
            mesh_lib.MeshSpec(data=-1, **{axis: 4}).resolve(8)
    with pytest.raises(ValueError):
        MeshSpec(data=3).resolve(4)
