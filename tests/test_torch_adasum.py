"""Adasum in the port (``parallel/adasum.py``, ``op=Adasum`` in the
collectives and in ``make_train_step``) against the reference: the fused
group with per-tensor coefficients at worlds 2 and 4 (gloo) over the replica
axes, one tensor with pre/postscale, ``grouped_allreduce``, one Adasum train
step, the power-of-two check at world 3, and the identity at world 1."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.parallel import collectives as rc
from horovod_tpu.parallel import dp as ref_dp
from horovod_tpu.parallel import mesh as mesh_lib
from horovod_tpu.parallel.adasum import adasum_allreduce_group as ref_group

import torch_dist_cases as cases
from test_torch_zero import odd_params_ref, ref_quadratic_loss

MESH = {2: (2, 1), 3: (3, 1), 4: (2, 2)}
TOL = dict(rtol=1e-5, atol=1e-6)


def ref_mesh(world):
    data, fsdp = MESH[world]
    return mesh_lib.build_mesh(mesh_lib.MeshSpec(data=data, fsdp=fsdp),
                               jax.devices()[:world])


def run_spmd(fn, world, *xs):
    """``fn`` of each replica's row of ``xs`` under shard_map; returns the
    outputs stacked per replica, [world, ...] each."""
    spec = P(("data", "fsdp"))
    mapped = jax.shard_map(
        lambda *vs: tuple(o[None] for o in fn(*[v[0] for v in vs])),
        mesh=ref_mesh(world), in_specs=tuple(spec for _ in xs),
        out_specs=spec, check_vma=False)
    return [np.asarray(o) for o in jax.jit(mapped)(*map(jnp.asarray, xs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {w: cases.spawn(w, tmp_path_factory.mktemp(f"adasum{w}"),
                           "adasum", mesh=MESH[w], timeout=300)
            for w in (2, 3, 4)}


def case_ids():
    return [(w, cases.axis_tag(a), a) for w in (2, 4)
            for a in cases.ADASUM_AXES[w]]


@pytest.mark.parametrize("world,tag,axis", case_ids(),
                         ids=lambda v: v if isinstance(v, (int, str))
                         else None)
def test_group_matches_reference(runs, world, tag, axis):
    """Per-tensor coefficients in one fused pass, equal on every
    replica."""
    want = run_spmd(lambda *vs: ref_group(list(vs), axis), world,
                    *cases.adasum_inputs(world))
    for rank, out in enumerate(runs[world]):
        for i, w in enumerate(want):
            np.testing.assert_allclose(out[f"group|{tag}|{i}"], w[rank],
                                       err_msg=f"{tag} {i} rank {rank}",
                                       **TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_allreduce_and_grouped_match_reference(runs, world):
    xs = cases.adasum_inputs(world)
    both = ("data", "fsdp")
    scaled = run_spmd(lambda v: [rc.allreduce(
        v, op=rc.Adasum, axis=both, prescale_factor=0.5,
        postscale_factor=3.0)], world, xs[1])[0]
    grouped = run_spmd(lambda *vs: rc.grouped_allreduce(
        list(vs), op=rc.Adasum, axis=both), world, *xs)
    for rank, out in enumerate(runs[world]):
        np.testing.assert_allclose(out["allreduce_scaled"], scaled[rank],
                                   **TOL)
        for i, w in enumerate(grouped):
            np.testing.assert_allclose(out[f"grouped|{i}"], w[rank], **TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_adasum_train_step_matches_reference(runs, world):
    """make_train_step(op=Adasum) with SGD against the reference's step on
    the same odd-sized parameters and batch."""
    mesh = mesh_lib.data_parallel_mesh(jax.devices()[:world])
    opt = optax.sgd(0.1)
    step = ref_dp.make_train_step(ref_quadratic_loss, opt, mesh,
                                  donate=False, op=rc.Adasum)
    params = odd_params_ref()
    out = step(ref_dp.replicate(params, mesh),
               ref_dp.replicate(opt.init(params), mesh),
               ref_dp.shard_batch({k: jnp.asarray(v) for k, v in
                                   cases.odd_batch().items()}, mesh),
               jax.random.key(0))
    want = {"scalar": out.params["scalar"], "vec": out.params["vec"],
            "mat": out.params["mat"], "deep_w": out.params["deep"]["w"]}
    for got in runs[world]:
        np.testing.assert_allclose(got["step|losses"][0], float(out.loss),
                                   rtol=1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(got[f"step|param/{name}"],
                                       np.asarray(w), err_msg=name, **TOL)


def test_world3_raises_like_the_reference(runs):
    for out in runs[3]:
        for name in ("group", "allreduce"):
            assert "power-of-two" in str(out[f"raised|{name}"]), name
    with pytest.raises(ValueError, match="power-of-two"):
        run_spmd(lambda v: ref_group([v], ("data", "fsdp")), 3,
                 np.zeros((3, 4), np.float32))


def test_world1_is_the_identity():
    from horovod_tpu_torch.parallel import collectives as c
    from horovod_tpu_torch.parallel.adasum import adasum_allreduce_group
    xs = [torch.tensor(v[0]) for v in cases.adasum_inputs(1)]
    hvd.init(device="cpu")
    try:
        outs = adasum_allreduce_group(xs, ("data", "fsdp"))
        for x, y in zip(xs, outs):
            assert torch.equal(x, y) and y is not x
        assert torch.equal(c.allreduce(xs[0], op=c.Adasum), xs[0])
        assert adasum_allreduce_group([]) == []
    finally:
        hvd.shutdown()
