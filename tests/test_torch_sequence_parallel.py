"""The port's ring and Ulysses attention against the reference's under
shard_map on a CPU mesh of the same size: at worlds 2 and 4 (gloo
processes over ``seq``), causal or not, on the flash path (the port's
plain kernel versions against the Pallas kernels in interpret mode) or
the plain one, outputs and q/k/v gradients of sum(o * w). Tolerances are
the reference tests' (rtol 2e-4 / atol 2e-5 forward, 2e-3 / 2e-4
gradients). A ``ppermute`` that records nothing for autograd (the port's
collective before it was differentiable) must make the ring's k/v
gradients differ."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.parallel import mesh as mesh_lib
from horovod_tpu.parallel.sp import ring_attention, ulysses_attention

import torch_dist_cases as cases

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)
FNS = {"ring": ring_attention, "ulysses": ulysses_attention}
SEQ = P(None, "seq")


@functools.lru_cache(maxsize=None)
def reference(world: int, fn: str, causal: bool, flash: bool) -> dict:
    """The reference's o and q/k/v gradients of sum(o * w), full [B, T,
    H, D] arrays, under shard_map over a ``seq`` mesh of ``world``."""
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=1, seq=world),
                               jax.devices()[:world])
    q, k, v, w = (jnp.asarray(a) for a in cases.sp_inputs())
    attend = functools.partial(FNS[fn], causal=causal, use_flash=flash)

    def local(q, k, v, w):
        o, vjp = jax.vjp(attend, q, k, v)
        return (o,) + vjp(w)
    mapped = jax.shard_map(local, mesh=mesh, in_specs=(SEQ,) * 4,
                           out_specs=(SEQ,) * 4, check_vma=False)
    outs = jax.jit(mapped)(q, k, v, w)
    return {key: np.asarray(o) for key, o in zip(("o", "dq", "dk", "dv"),
                                                  outs)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return cases.spawn(2, tmp_path_factory.mktemp("sp2"), "sp",
                       mesh={"data": 1, "seq": 2})


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return cases.spawn(4, tmp_path_factory.mktemp("sp4"), "sp",
                       mesh={"data": 1, "seq": 4})


def gathered(outs, key):
    """Every rank's shard of ``key``, concatenated along the sequence."""
    return np.concatenate([o[key] for o in outs], axis=1)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fn,causal,flash", cases.SP_CASES,
                         ids=[cases.sp_tag(*c) for c in cases.SP_CASES])
def test_matches_reference(world, fn, causal, flash, request):
    outs = request.getfixturevalue(f"world{world}")
    want = reference(world, fn, causal, flash)
    tag = cases.sp_tag(fn, causal, flash)
    for key in ("o", "dq", "dk", "dv"):
        np.testing.assert_allclose(gathered(outs, f"{tag}|{key}"), want[key],
                                   **(FWD if key == "o" else GRAD),
                                   err_msg=f"{tag} {key}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("flash", [False, True])
def test_ppermute_without_autograd_breaks_kv_grads(world, flash, request):
    """The mutation check: with the ring's rotations invisible to autograd
    the k/v gradients keep only the local block's share."""
    outs = request.getfixturevalue(f"world{world}")
    want = reference(world, "ring", True, flash)
    for key in ("dk", "dv"):
        got = gathered(outs, f"mutant|{int(flash)}|{key}")
        assert not np.allclose(got, want[key], **GRAD), key


def test_world1_ring_and_ulysses_are_one_attention_call():
    """At world 1 both take one flash call (or one block) on the whole
    sequence: bit-equal to flash_attention, and a seq axis of size 1 is
    the identity for the all-to-alls."""
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import ring_attention as ring
    from horovod_tpu_torch.parallel import ulysses_attention as uly
    hvd.init(device="cpu")
    try:
        q, k, v, _ = (torch.tensor(a) for a in cases.sp_inputs())
        want = fa.flash_attention(q, k, v, causal=True)
        assert torch.equal(ring(q, k, v, causal=True, use_flash=True), want)
        assert torch.equal(uly(q, k, v, causal=True, use_flash=True), want)
    finally:
        hvd.shutdown()


def test_ulysses_rejects_heads_not_divisible(monkeypatch):
    from horovod_tpu_torch.parallel import sp
    monkeypatch.setattr(sp.collectives, "axis_size", lambda axis: 2)
    x = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match="divisible"):
        sp.ulysses_attention(x, x, x)
