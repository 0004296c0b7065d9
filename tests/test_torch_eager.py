"""The port's name-negotiated eager ops (``horovod_tpu_torch/common/
eager.py``, ``mpi_ops.py``) against the reference's eager executor.

The reference runs on a loopback ``EngineSession`` ring of four (as the
``ring`` fixture of tests/test_eager_ops.py does), the port as four gloo
processes, on the same numpy inputs (``torch_dist_cases.eager_cases``):
every op and dtype, Average with scales, Min, Max, Product, Adasum (also
against the closed form at worlds 2 and 4), the ragged allgather, a
broadcast from a non-zero root, even and uneven alltoall, mixed fused
tensors, a grouped allreduce, the same names submitted in rank-dependent
orders, the three join cases and a dtype mismatch. Integers must be equal,
fp32 within rtol 1e-6, 16-bit floats within the reference test's rtol
1e-2. Every op waits at most ``EAGER_TIMEOUT`` seconds on either side."""

import threading
import time
import uuid
import zlib

import numpy as np
import pytest
import torch

from horovod_tpu.common import eager as ref_eager
from horovod_tpu.common.exceptions import HorovodInternalError
from horovod_tpu.engine import EngineSession, bindings
from horovod_tpu.jax.mpi_ops import (_OP_ALLGATHER, _OP_ALLREDUCE,
                                     _OP_ALLTOALL, _OP_BROADCAST,
                                     EagerExecutor)
from horovod_tpu.parallel import collectives as rc
from horovod_tpu_torch.common import eager

import torch_dist_cases as cases

N = 4
T = cases.EAGER_TIMEOUT
OP_TYPES = {"allreduce": _OP_ALLREDUCE, "allgather": _OP_ALLGATHER,
            "broadcast": _OP_BROADCAST, "alltoall": _OP_ALLTOALL}


def np_dtype(dtype: str):
    import ml_dtypes
    return {"bfloat16": ml_dtypes.bfloat16}.get(dtype, np.dtype(dtype))


def load_engine():
    """The engine library, built by make on first use; another test
    process may be building it at the same moment, so a failed first
    load is tried again once the other build has had time to finish."""
    for attempt in range(3):
        try:
            return bindings.load_library()
        except (RuntimeError, OSError):
            if attempt == 2:
                raise
            time.sleep(10)


def run_all(executors, fn):
    """fn(rank, executor) on one thread per rank; the per-rank results."""
    results, errors = [None] * len(executors), [None] * len(executors)

    def work(r):
        try:
            results[r] = fn(r, executors[r])
        except Exception as e:  # noqa: BLE001
            errors[r] = e

    threads = [threading.Thread(target=work, args=(r,))
               for r in range(len(executors))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def ref_submit(ex, o):
    """Submit one op of ``eager_cases`` to a reference executor; the names
    and handles it made."""
    def arr(x):
        return np.asarray(x).astype(np_dtype(o["dtype"]))
    kind = o["type"]
    if kind == "grouped":
        gid = zlib.crc32(o["name"].encode()) & 0x3fffffff
        names = [f"{o['name']}.{i}" for i in range(len(o["x"]))]
        return [(n, ex.submit(n, _OP_ALLREDUCE, arr(x),
                              reduce_op=getattr(rc, o["op"]), group_id=gid,
                              group_size=len(names)))
                for n, x in zip(names, o["x"])]
    kw = {}
    if kind == "allreduce":
        kw = dict(reduce_op=getattr(rc, o["op"]),
                  prescale=o.get("prescale", 1.0),
                  postscale=o.get("postscale", 1.0))
    elif kind == "broadcast":
        kw = dict(root_rank=o["root"])
    elif kind == "alltoall" and o.get("splits") is not None:
        kw = dict(splits=o["splits"])
    return [(o["name"], ex.submit(o["name"], OP_TYPES[kind], arr(o["x"]),
                                  **kw))]


def ref_run(ex, r, case_ops) -> dict:
    out = {}
    handles = [h for o in case_ops[r] for h in ref_submit(ex, o)]
    for name, h in handles:
        ex.session.wait(h, timeout=T)
        aux = {}
        out[name] = np.asarray(ex.take_result(name, aux_out=aux), np.float64)
        for kind, v in aux.items():
            out[f"{name}|{kind}"] = np.asarray(v)
    return out


def ref_joins(ex, r) -> dict:
    """The three join cases and the mismatch, as ``run_eager`` runs
    them."""
    out = {}

    def join():
        ex.session.wait(ex.session.join(), timeout=T)

    def reduce(name, x, op):
        h = ex.submit(name, _OP_ALLREDUCE, x, reduce_op=op)
        ex.session.wait(h, timeout=T)
        return np.asarray(ex.take_result(name), np.float64)
    if r == N - 1:
        join()
    else:
        for name in ("Min", "Max", "Product"):
            out[f"join_identity|{name}"] = reduce(
                f"j{name}", np.asarray([r + 1.0, -(r + 1.0)], np.float32),
                getattr(rc, name))
        join()
    if r == 2:
        join()
    else:
        h = ex.submit("jgather", _OP_ALLGATHER,
                      np.full((r + 1, 3), float(r), np.float32))
        ex.session.wait(h, timeout=T)
        out["join_allgather"] = np.asarray(ex.take_result("jgather"))
        join()
    time.sleep(0.05 * r if r != 1 else 1.0)
    join()
    out["join_last"] = ex.session.last_joined_rank()
    try:
        reduce("bad", np.ones(3, np.int32 if r == 1 else np.float32), rc.Sum)
        out["mismatch"] = ""
    except HorovodInternalError as err:
        out["mismatch"] = str(err)
    return out


@pytest.fixture(scope="module")
def ref():
    """Every case on the reference's loopback ring of four: rank -> key ->
    result, keyed as ``run_eager`` keys the port's."""
    load_engine()
    group = f"torch-eager-{uuid.uuid4().hex[:8]}"
    sessions = [EngineSession(rank=r, size=N, transport="loopback",
                              group=group, cycle_time_ms=1.0)
                for r in range(N)]
    executors = [EagerExecutor(s) for s in sessions]
    try:
        outs = [{} for _ in range(N)]
        for case, case_ops in cases.eager_cases(N).items():
            for r, res in enumerate(run_all(
                    executors, lambda r, ex: ref_run(ex, r, case_ops))):
                outs[r].update({f"{case}|{k}": v for k, v in res.items()})
        for r, res in enumerate(run_all(executors, lambda r, ex:
                                        ref_joins(ex, r))):
            outs[r].update(res)
        return outs
    finally:
        for s in sessions:
            s._lib.hvdtpu_shutdown(s._session)
        for s in sessions:
            s.destroy()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return cases.spawn(N, tmp_path_factory.mktemp("eager4"), "eager",
                       timeout=180)


# the dtype of every op of eager_cases, by ``case|name``
DTYPES = {f"{case}|{o['name']}": o["dtype"]
          for case, ops in cases.eager_cases(N).items() for o in ops[0]}


def tolerance(key: str) -> dict:
    """Equal for integers (and the aux counts), rtol 1e-6 for fp32, the
    reference test's rtol 1e-2 for 16-bit floats."""
    base = key.rsplit("|", 1)[0] if key.endswith(
        ("rank_sizes", "recv_splits")) else key
    dtype = DTYPES.get(base) or DTYPES[base.rsplit(".", 1)[0]]
    if key.endswith(("rank_sizes", "recv_splits")) or dtype == "int32":
        return dict(rtol=0, atol=0)
    if dtype in ("bfloat16", "float16"):
        return dict(rtol=1e-2)
    return dict(rtol=1e-6)


@pytest.mark.parametrize("case", sorted(cases.eager_cases(N)))
def test_eager_op_matches_reference(ref, port, case):
    """Every rank's outputs (and the allgather's rank sizes, the
    alltoall's receive splits) equal the reference executor's."""
    for r in range(N):
        keys = sorted(k for k in ref[r] if k.startswith(case + "|"))
        assert keys and keys == sorted(
            k for k in port[r] if k.startswith(case + "|")), (r, keys)
        for k in keys:
            want, got = ref[r][k], port[r][k]
            assert got.shape == want.shape, (k, got.shape, want.shape)
            np.testing.assert_allclose(got, want, err_msg=k,
                                       **tolerance(k))


def adasum_closed_form(vecs) -> np.ndarray:
    """The binary Adasum tree in float64 (data_plane.cc AdasumPair)."""
    vecs = [np.asarray(v, np.float64) for v in vecs]
    level = 1
    while level < len(vecs):
        for r in range(0, len(vecs) - level, 2 * level):
            a, b = vecs[r], vecs[r + level]
            dot, na, nb = a @ b, a @ a, b @ b
            vecs[r] = (1 - dot / (2 * na)) * a + (1 - dot / (2 * nb)) * b
        level <<= 1
    return vecs[0]


@pytest.mark.parametrize("world", [2, 4])
def test_eager_adasum_matches_closed_form(port, tmp_path, world):
    ops = cases.eager_cases(world)["adasum|float32"]
    want = adasum_closed_form([ops[r][0]["x"] for r in range(world)])
    if world == N:
        outs = [{"adasum": p["adasum|float32|ada"]} for p in port]
    else:
        outs = cases.spawn(world, tmp_path, "eager_adasum", timeout=120)
    for out in outs:
        np.testing.assert_allclose(out["adasum"], want, rtol=1e-6)


def test_eager_out_of_order_submission(ref, port):
    """Rank r submits the same five names in its own rotated (and on odd
    ranks reversed) order; every name still reduces its own tensors."""
    ops = cases.eager_cases(N)["out_of_order|float32"]
    assert len({tuple(o["name"] for o in per) for per in ops}) == N
    for name in (o["name"] for o in ops[0]):
        want = sum(next(o["x"] for o in ops[r] if o["name"] == name)
                   for r in range(N))
        for r in range(N):
            np.testing.assert_allclose(
                port[r][f"out_of_order|float32|{name}"], want, rtol=1e-6)


def test_join_identity_min_max_product(ref, port):
    """A joined rank takes part with the op's identity: Min, Max and
    Product see only the active ranks."""
    active = np.asarray([[r + 1.0, -(r + 1.0)] for r in range(N - 1)])
    want = {"Min": active.min(0), "Max": active.max(0),
            "Product": active.prod(0)}
    for r in range(N - 1):
        for name, w in want.items():
            key = f"join_identity|{name}"
            np.testing.assert_allclose(port[r][key], ref[r][key])
            np.testing.assert_allclose(port[r][key], w)
    assert not any(k.startswith("join_identity") for k in port[N - 1])


def test_join_allgather_zero_rows(ref, port):
    """A joined rank contributes no rows to an allgather."""
    want = np.concatenate([np.full((r + 1, 3), float(r))
                           for r in range(N) if r != 2])
    for r in range(N):
        if r != 2:
            np.testing.assert_allclose(port[r]["join_allgather"],
                                       ref[r]["join_allgather"])
            np.testing.assert_allclose(port[r]["join_allgather"], want)


def test_join_returns_last_joined_rank(ref, port):
    """join() returns the rank that joined last, on every rank."""
    assert [int(p["join_last"]) for p in port] == [1] * N
    assert [r["join_last"] for r in ref] == [1] * N


def test_dtype_mismatch_fails_on_every_rank(ref, port):
    """Ranks that disagree on the dtype fail the op everywhere, with the
    reference controller's message naming the field."""
    for r in range(N):
        assert "Mismatched data types" in ref[r]["mismatch"]
        msg = str(port[r]["mismatch"])
        assert msg.startswith("Mismatched data types: rank 0 has float32, "
                              "rank 1 has int32 for tensor bad"), msg


@pytest.mark.parametrize("op,pre,post", [
    ("Sum", 1.0, 1.0), ("Average", 2.0, 0.5), ("Min", 1.0, 1.0),
    ("Product", 1.0, 3.0), ("Adasum", 0.5, 1.0)])
def test_size_one_ops_before_init(op, pre, post):
    """Before init() the ops take their size-1 semantics, as the
    reference's do without an engine: complete handles, the input scaled,
    the aux of one rank."""
    import horovod_tpu_torch as hvd
    assert not hvd.is_initialized()
    x = np.asarray([[1.5, -2.0], [3.0, 0.25]], np.float32)
    h = eager.allreduce_async(torch.tensor(x), op=getattr(hvd, op),
                              prescale_factor=pre, postscale_factor=post)
    want = ref_eager.synchronize(ref_eager.allreduce_async(
        x, op=getattr(rc, op), prescale_factor=pre, postscale_factor=post))
    assert isinstance(h, eager.LocalHandle) and eager.poll(h)
    np.testing.assert_allclose(eager.synchronize(h).numpy(), want)
    ag = eager.allgather_async(torch.tensor(x))
    ref_ag = ref_eager.allgather_async(x)
    np.testing.assert_array_equal(eager.synchronize(ag).numpy(),
                                  ref_eager.synchronize(ref_ag))
    assert list(ag.aux["rank_sizes"]) == list(ref_ag.aux["rank_sizes"])
    a2a = eager.alltoall_async(torch.tensor(x), splits=[2])
    assert a2a.aux["recv_splits"] == [2]
    assert eager.join() == ref_eager.join() == -1
    np.testing.assert_array_equal(
        hvd.metric_average(3.5).numpy(), 3.5)


def test_resolve_op_matches_reference():
    for average in (None, True, False):
        for op in (None, "Sum", "Min"):
            got = eager.resolve_op(op and getattr(eager, op), average)
            want = ref_eager.resolve_op(op and getattr(rc, op), average)
            assert got.value == want.value


def test_identity_buffer_matches_reference():
    from horovod_tpu.common.reduce_ops import REDUCE_KIND
    for op in ("Sum", "Average", "Min", "Max", "Product", "Adasum"):
        for dtype in ("float32", "int32", "bool"):
            got = eager.identity_buffer((2, 3), getattr(torch, dtype),
                                        getattr(eager, op), "cpu")
            want = ref_eager.identity_buffer(
                (2, 3), dtype, REDUCE_KIND[getattr(rc, op)])
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{op} {dtype}")


def test_concurrent_submissions_lose_nothing():
    """Eight threads submit 40 named allreduces each while the
    negotiation thread runs rounds, with the interpreter switching threads
    every microsecond: every handle completes with its own tensor."""
    import sys
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    results, errors = {}, []

    def work(t):
        try:
            handles = [(i, eager.allreduce_async(
                torch.full((3,), float(100 * t + i)), name=f"s{t}.{i}",
                op=hvd.Sum)) for i in range(40)]
            for i, h in handles:
                results[(t, i)] = eager.synchronize(h, timeout=T)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        hvd.shutdown()
    assert errors == [] and len(results) == 8 * 40
    for (t, i), out in results.items():
        np.testing.assert_array_equal(out.numpy(), np.full(3, 100 * t + i))
