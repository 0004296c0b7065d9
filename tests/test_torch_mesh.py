"""The port's mesh against the reference's ``build_mesh``: every axis and
set of axes resolves to the same sizes, and every group of ranks the port
makes holds the devices the reference's mesh puts on that axis, in the
same order (ranks row-major in AXIS_ORDER, as the reference reshapes its
device list), at worlds 4 and 8; ``axis_index`` of a tuple in any order
agrees with the mesh coordinates."""

import itertools

import numpy as np
import jax
import pytest

from horovod_tpu.parallel import mesh as mesh_lib
from horovod_tpu_torch.parallel import mesh

# every axis above 1 at least once, alone and together, at each world
SPECS = {
    4: [dict(data=4), dict(fsdp=4), dict(data=1, model=4),
        dict(data=1, seq=4), dict(data=1, pipe=4), dict(data=1, expert=4),
        dict(data=2, model=2), dict(data=1, pipe=2, seq=2),
        dict(data=1, expert=2, model=2), dict(data=2, fsdp=2)],
    8: [dict(data=2, fsdp=2, model=2), dict(data=1, pipe=2, expert=2, seq=2),
        dict(pipe=2, model=4, data=1), dict(data=-1, seq=2, model=2),
        dict(data=1, fsdp=2, expert=4), dict(data=8)],
}
CASES = [(w, s) for w, specs in SPECS.items() for s in specs]


def reference_groups(ref_mesh, axes):
    """Rows of device ids: one per coordinate of the other axes, each the
    devices along ``axes`` (in AXIS_ORDER) row-major."""
    ids = np.vectorize(lambda d: d.id)(ref_mesh.devices)
    names = list(ref_mesh.axis_names)
    keep = [names.index(a) for a in names if a not in axes]
    move = [names.index(a) for a in axes]
    arr = ids.transpose(keep + move)
    return arr.reshape(-1, int(np.prod([ref_mesh.shape[a] for a in axes],
                                       dtype=int))).tolist()


@pytest.mark.parametrize("world,spec", CASES,
                         ids=[f"{w}-{s}" for w, s in CASES])
def test_groups_match_build_mesh(world, spec):
    devices = jax.devices()[:world]
    ref = mesh_lib.build_mesh(mesh_lib.MeshSpec(**spec), devices)
    sizes = mesh.MeshSpec(**spec).resolve(world)
    assert sizes == mesh_lib.MeshSpec(**spec).resolve(world)
    assert tuple(ref.axis_names) == mesh.AXIS_ORDER
    # device ids are the reference's ranks here: devices[:world] are 0..n-1
    assert [d.id for d in devices] == list(range(world))
    for n in range(0, len(mesh.AXIS_ORDER) + 1):
        for axes in itertools.combinations(mesh.AXIS_ORDER, n):
            want = reference_groups(ref, axes)
            assert mesh.axis_groups(sizes, axes) == want, axes
            key = mesh.group_key(sizes, axes)
            assert key in mesh.group_sets(sizes), axes
            # the group a module's axes map to holds the same ranks
            assert sorted(map(sorted, mesh.axis_groups(sizes, key))) == \
                sorted(map(sorted, want)), axes


@pytest.mark.parametrize("world,spec", CASES,
                         ids=[f"{w}-{s}" for w, s in CASES])
def test_axis_index_follows_mesh_coordinates(world, spec):
    ref = mesh_lib.build_mesh(mesh_lib.MeshSpec(**spec),
                              jax.devices()[:world])
    sizes = mesh.MeshSpec(**spec).resolve(world)
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    for rank in range(world):
        coord = dict(zip(ref.axis_names,
                         (int(c) for c in np.argwhere(ids == rank)[0])))
        assert mesh.coords(sizes, rank) == coord
        for axes in itertools.permutations(("seq", "model", "data"), 2):
            want = coord[axes[0]] * sizes[axes[1]] + coord[axes[1]]
            assert mesh.axis_index(sizes, rank, axes) == want


def test_group_sets_cover_only_long_axes():
    """The replica sets always (the gradient exchange goes through the
    backend even at world 1), every subset of the axes longer than 1, and
    the ranks alone: not all 63 subsets."""
    sizes = mesh.MeshSpec(data=1, pipe=2, seq=2).resolve(4)
    assert mesh.group_sets(sizes) == [
        ("data",), ("fsdp",), ("data", "fsdp"), ("pipe",), ("seq",),
        ("pipe", "seq"), ()]
    assert mesh.group_key(sizes, ("seq", "model")) == ("seq",)
    assert mesh.group_key(sizes, ("model",)) == ()
    assert mesh.group_key(sizes, ("data",)) == ("data",)
