"""The rest of the port's collectives (Product, grouped_allreduce,
hierarchical_allreduce, allgather, alltoall, reducescatter, ppermute,
broadcast and barrier over an axis, axis_rank/axis_size) against the
reference's under shard_map: at world 1 in process, at world 2 as two gloo
processes against a 2-device mesh, and at world 4 as a data=2 x fsdp=2 job
against a 4-device reference mesh of the same layout, over ``"data"``,
``"fsdp"`` and both, in either order (a tuple indexes the replicas row-major
in the order it names the axes). Also the topology queries and the mesh
spec."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.parallel import collectives as rc
from horovod_tpu.parallel import mesh as mesh_lib

import torch_dist_cases as cases

TOL = {"float32": 1e-6, "bfloat16": 8e-3, "int32": 0.0}
REPLICAS = P(("data", "fsdp"))


def ref_mesh(world):
    spec = mesh_lib.MeshSpec(data=2, fsdp=2) if world == 4 else \
        mesh_lib.MeshSpec(data=world)
    return mesh_lib.build_mesh(spec, jax.devices()[:world])


def ref_case(name, world, axis):
    """The reference's outputs of one case, [world, ...] per tensor (row r
    is rank r's result)."""
    fn, dtype, _, _ = cases.MORE_CASES[name]
    dtypes = cases.GROUPED_DTYPES if dtype == "mixed" else (dtype,)
    xs = [jnp.asarray(v, getattr(jnp, dt))
          for v, dt in zip(cases.more_case_input(name, world), dtypes)]
    mesh = ref_mesh(world)
    axes = axis if isinstance(axis, tuple) else (axis or "data",)
    kw = cases.more_case_kwargs(name, int(np.prod([mesh.shape[a]
                                                    for a in axes])))
    if "op" in kw:
        kw["op"] = getattr(rc, kw["op"])
    if axis is not None:
        kw["axis"] = axis

    def local(*vs):
        vs = [v[0] for v in vs]
        ys = getattr(rc, fn)(vs if fn == "grouped_allreduce" else vs[0],
                             **kw)
        return tuple(y[None] for y in (ys if isinstance(ys, list) else [ys]))
    mapped = jax.shard_map(local, mesh=mesh,
                           in_specs=tuple(REPLICAS for _ in xs),
                           out_specs=tuple(REPLICAS for _ in xs),
                           check_vma=False)
    return [np.asarray(o, np.float32) for o in jax.jit(mapped)(*xs)]


def case_ids(world):
    return [(name, tag, axis) for name in sorted(cases.MORE_CASES)
            for tag, axis in cases.more_case_axes(name, world)]


def check(outs, world, name, tag, axis):
    dtype = cases.MORE_CASES[name][1]
    dtypes = cases.GROUPED_DTYPES if dtype == "mixed" else (dtype,)
    want = ref_case(name, world, axis)
    for rank, out in enumerate(outs):
        for i, (w, dt) in enumerate(zip(want, dtypes)):
            np.testing.assert_allclose(out[f"{name}|{tag}|{i}"], w[rank],
                                       rtol=TOL[dt], atol=TOL[dt],
                                       err_msg=f"{name} {tag} rank {rank}")


@pytest.fixture(scope="module")
def world1():
    hvd.init(device="cpu")
    try:
        return [cases.run_more_collectives(0, 1)]
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return cases.spawn(2, tmp_path_factory.mktemp("more2"),
                       "collectives_more")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return cases.spawn(4, tmp_path_factory.mktemp("more4"),
                       "collectives_more", mesh=(2, 2))


@pytest.mark.parametrize("name,tag,axis", case_ids(1),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_world1_matches_reference(world1, name, tag, axis):
    check(world1, 1, name, tag, axis)


@pytest.mark.parametrize("name,tag,axis", case_ids(2),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_world2_matches_reference(world2, name, tag, axis):
    check(world2, 2, name, tag, axis)


@pytest.mark.parametrize("name,tag,axis", case_ids(4),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_world4_data2_fsdp2_matches_reference(world4, name, tag, axis):
    check(world4, 4, name, tag, axis)


def test_axis_layout_world4(world4):
    """fsdp is the fast axis: its groups are runs of consecutive ranks, the
    data groups strided ranks, both axes the world; ("fsdp", "data")
    indexes the world with data as the fast axis."""
    for rank, out in enumerate(world4):
        assert out["axis|data"].tolist() == [rank // 2, 2]
        assert out["axis|fsdp"].tolist() == [rank % 2, 2]
        assert out["axis|data+fsdp"].tolist() == [rank, 4]
        assert out["axis|fsdp+data"].tolist() == [(rank % 2) * 2 + rank // 2,
                                                  4]


def test_replica_groups_layout():
    from horovod_tpu_torch.parallel.mesh import replica_groups
    groups = replica_groups({"data": 2, "fsdp": 3})
    assert groups[("fsdp",)] == [[0, 1, 2], [3, 4, 5]]
    assert groups[("data",)] == [[0, 3], [1, 4], [2, 5]]
    assert groups[("data", "fsdp")] == [list(range(6))]


def test_unsupported_arguments_raise():
    """Adasum and a reversed axis tuple run (at world 1 both give the
    input), and so does every other mesh axis (size 1 here: the input);
    an unknown axis, a repeated axis and the reference's own refusals
    raise."""
    from horovod_tpu_torch.parallel import collectives as c
    hvd.init(device="cpu")
    try:
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(c.allreduce(x, op=c.Adasum), x)
        assert torch.equal(c.grouped_allreduce([x, x[0]], op=c.Adasum)[1],
                           x[0])
        assert torch.equal(c.allreduce(x, axis=("fsdp", "data")), x)
        assert c.axis_rank(("fsdp", "data")) == 0
        assert torch.equal(c.allgather(x, axis="model"), x)
        assert torch.equal(c.allgather(x, axis=("seq", "data")), x)
        with pytest.raises(ValueError, match="mesh axes"):
            c.allgather(torch.ones(2), axis="tensor")
        with pytest.raises(ValueError, match="once"):
            c.allreduce(torch.ones(2), axis=("data", "data"))
        with pytest.raises(ValueError, match="Sum/Average"):
            c.reducescatter(torch.ones(2), op=c.Max)
        with pytest.raises(ValueError, match="permutation"):
            c.ppermute(torch.ones(2), [(0, 0), (0, 0)])
        with pytest.raises(ValueError, match="permutation"):
            c.ppermute(torch.ones(2), [(0, 1)])
        with pytest.raises(ValueError, match="Sum/Average"):
            c.quantized_allreduce(torch.ones(2), op=c.Max)
    finally:
        hvd.shutdown()


def test_topology_queries_follow_the_env(monkeypatch):
    hvd.init(device="cpu")
    try:
        assert (hvd.local_size(), hvd.cross_rank(), hvd.cross_size()) == \
            (1, 0, 1)
    finally:
        hvd.shutdown()
    monkeypatch.setenv("HOROVOD_LOCAL_SIZE", "4")
    monkeypatch.setenv("HOROVOD_CROSS_RANK", "2")
    monkeypatch.setenv("HOROVOD_CROSS_SIZE", "3")
    hvd.init(device="cpu")
    try:
        assert (hvd.local_size(), hvd.cross_rank(), hvd.cross_size()) == \
            (4, 2, 3)
    finally:
        hvd.shutdown()
    with pytest.raises(ValueError, match="init"):
        hvd.cross_size()
