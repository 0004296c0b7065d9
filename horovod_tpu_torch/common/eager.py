"""Name-negotiated eager collectives on the device.

Counterpart of ``horovod_tpu/common/eager.py`` and of the part of the
engine's controller (``horovod_tpu/engine/src/controller.cc``) that decides
which ops are ready. Ranks may submit the same named ops in different
orders (reference ``jax/mpi_ops.py:3-5``), but ``torch.distributed`` needs
every rank to issue its collectives in one order, so a background thread
negotiates:

- ``submit`` never blocks. It records a CUDA event on the caller's stream,
  keeps the input alive on the handle and wakes the thread.
- The thread runs rounds on the gloo control group while this rank has an
  op waiting or has joined; an op can only complete in a round that every
  rank enters, so an idle rank loses nothing by sleeping, and the step's
  host path pays nothing when no eager op is pending. Each round
  all-gathers every rank's new requests (name, op type, dtype, shape,
  root, reduce op, scales, splits, group) and its join flag. Every rank
  applies the same rounds to the same table, so every rank takes the same
  decisions without a coordinator.
- An op is ready when every rank that has not joined has submitted it (a
  grouped allreduce when all of its members are). Ready ops launch in the
  table's order, which puts rank 0's requests of a round first, in its
  submission order. They run on the data group: on the card on a side
  stream that first waits on each input's event. Ready allreduces of one
  dtype, op and scale pair fuse up to ``HOROVOD_FUSION_THRESHOLD`` bytes
  (reference eager.py:210-240).
- Ranks that disagree on an op's type, dtype, shape, root or reduce op
  fail its handle on every rank with a message naming the field, as the
  reference's controller does (controller.cc:128-172).
- A joined rank contributes the reduce op's identity element to an
  allreduce (:func:`identity_buffer`) and zero rows to an allgather or
  alltoall; Average still divides by the full size
  (``engine/src/data_plane.cc:1068-1070``). :func:`join` returns once
  every rank has joined.

Every op's lifecycle goes into the flight recorder
(``common/flight_recorder.py``) where the reference's engine records it
(``engine.cc``): ENQUEUE at ``submit`` (aux = the request's signature,
``message.cc`` ``ComputeSignature``), NEGOTIATE when the round that tells
the others runs, a CYCLE anchor after each non-idle round's exchange
(cycle = the round, which every rank leaves together), FUSE and EXEC per
op of a launch unit, DONE after it (aux = the unit's exec span in µs;
on the card read from CUDA events when the ring is dumped, never by
synchronizing the side stream) and DESYNC when the ranks disagree. The
queue depth and the tensors per launch go to the metrics registry under
the reference engine's names (``hvd_engine_queue_depth``,
``hvd_engine_responses_total``, ``hvd_engine_fused_tensors_total``).

The engine's knobs of the round (``engine/src/controller.cc``):

- tuned parameters (:class:`~horovod_tpu_torch.common.parameter_manager.
  TunedParams`: cycle time, fusion threshold, response cache on or off,
  express lane and its threshold). Rank 0's push
  (:meth:`EagerExecutor.set_tuned_params`, or the ``HOROVOD_AUTOTUNE``
  parameter manager's choice) rides its message of the next round, and
  every rank adopts it at the end of that round, so every rank cuts the
  same fused batches. At world > 1 a push needs ``HOROVOD_TUNE`` or
  ``HOROVOD_AUTOTUNE``, as the reference's does;
- the express lane: with ``HOROVOD_SERVING_MODE`` or a pushed express
  lane, a ready ungrouped data op of at most the low-latency threshold
  never fuses and launches ahead of the round's bulk units;
- the response cache (``common/response_cache.py``): a name negotiated
  before with identical fields is announced by its cache position;
- the stall inspector (``common/stall_inspector.py``), run by every rank
  on the same table and rank 0's clock (carried in its message), so every
  rank warns, and fails its ops at the shutdown deadline, in one round. A
  rank whose thread has waited in a round for a quarter of the warning
  time (at most 1 s) posts the round's number to the job's store, and an
  idle rank, which otherwise sleeps, polls for it and joins the round, so
  a missing rank is named while it sits idle;
- the timeline (``common/timeline.py``, ``HOROVOD_TIMELINE`` on rank 0 or
  :func:`start_timeline`).

Before ``init()`` the ops take their size-1 semantics (:class:`LocalHandle`),
as the reference's do without an engine.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import uuid
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import flight_recorder as fr
from horovod_tpu_torch.common.env import (env_bool, env_float, env_int,
                                          env_str)
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.common.hvd_logging import get_logger
from horovod_tpu_torch.common.parameter_manager import (ParameterManager,
                                                        TunedParams)
from horovod_tpu_torch.common.response_cache import HIT, INVALID, \
    ResponseCache
from horovod_tpu_torch.common.stall_inspector import StallInspector
from horovod_tpu_torch.common.timeline import Timeline
from horovod_tpu_torch.common.reduce_ops import (Adasum, Average, Max, Min,
                                                 Op, Product, Sum)
from horovod_tpu_torch.profiler.annotate import host_annotation
from horovod_tpu_torch.verify import rules

ALLREDUCE, ALLGATHER, BROADCAST, ALLTOALL, BARRIER = (
    "allreduce", "allgather", "broadcast", "alltoall", "barrier")

_DIST_OPS = {Sum: dist.ReduceOp.SUM, Average: dist.ReduceOp.SUM,
             Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX,
             Product: dist.ReduceOp.PRODUCT}

# the engine's codes (common.h OpType, reduce_ops.py REDUCE_KIND)
_OP_CODES = {ALLREDUCE: fr.OP_ALLREDUCE, ALLGATHER: fr.OP_ALLGATHER,
             BROADCAST: fr.OP_BROADCAST, ALLTOALL: fr.OP_ALLTOALL,
             BARRIER: fr.OP_BARRIER}
_REDUCE_KIND = {Sum.value: 0, Average.value: 1, Min.value: 2, Max.value: 3,
                Product.value: 4, Adasum.value: 5}


class Request(NamedTuple):
    """What a rank tells the others about one op it submitted."""
    name: str
    op_type: str
    dtype: str                # e.g. "float32"
    shape: Tuple[int, ...]
    root: int = 0
    reduce_op: str = Sum.value
    prescale: float = 1.0
    postscale: float = 1.0
    splits: Optional[Tuple[int, ...]] = None
    group_id: int = -1
    group_size: int = 0


class Handle:
    """An op in flight (reference eager.py ``Handle``). ``aux`` gets
    ``rank_sizes`` (allgather: the rows each rank gave) or ``recv_splits``
    (alltoall: the rows received from each rank) when the op completes."""

    def __init__(self, name: Optional[str], tensor=None):
        self.name = name
        self.aux: dict = {}
        self._input = tensor     # kept alive until the op is launched
        self._ready = None       # CUDA event: the input is written
        self._launched = threading.Event()
        self._event = None       # CUDA event: the output is written
        self._result = None
        self._error: Optional[str] = None

    def _finish(self, result=None, error=None, event=None, aux=None):
        self._result, self._error, self._event = result, error, event
        self.aux.update(aux or {})
        self._input = None
        self._launched.set()

    def __repr__(self):
        return f"<hvd handle {self.name}>"


class LocalHandle:
    """An op already complete: the size-1 result before ``init()``."""

    def __init__(self, result, aux=None):
        self.result = result
        self.aux = aux or {}


def identity_buffer(shape, dtype: torch.dtype, op: Op,
                    device) -> torch.Tensor:
    """The identity element of ``op`` (reference eager.py:329-350): a
    joined rank's allreduce input. Sum, Average and Adasum: zeros
    (Adasum's zero-norm guard combines a zero vector as the identity);
    Min: +inf or the dtype's max; Max: -inf or its min; Product: ones."""
    if op in (Min, Max):
        if dtype == torch.bool:
            value = op is Min
        elif dtype.is_floating_point:
            value = float("inf") if op is Min else float("-inf")
        else:
            info = torch.iinfo(dtype)
            value = info.max if op is Min else info.min
        return torch.full(shape, value, dtype=dtype, device=device)
    if op is Product:
        return torch.ones(shape, dtype=dtype, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


def _scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x * factor`` through float64, rounded (floats) or truncated
    (integers) back to the dtype, as the data plane's ScaleBuffer does."""
    if factor == 1.0 or x.dtype == torch.bool:
        return x
    return (x.double() * factor).to(x.dtype)


def _adasum_tree(vecs: torch.Tensor) -> torch.Tensor:
    """The data plane's binary Adasum tree over the rows of ``vecs`` (one
    per rank, float64): level l combines row r with row r + l
    (data_plane.cc:1036-1053)."""
    vecs = list(vecs)
    level = 1
    while level < len(vecs):
        for r in range(0, len(vecs) - level, 2 * level):
            a, b = vecs[r], vecs[r + level]
            dot, na, nb = a @ b, a @ a, b @ b
            ac = 1.0 - dot / (2 * na) if na != 0 else 1.0
            bc = 1.0 - dot / (2 * nb) if nb != 0 else 1.0
            vecs[r] = ac * a + bc * b
        level <<= 1
    return vecs[0]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _check(subs: Dict[int, Request]) -> Optional[str]:
    """The first disagreement of the ranks' requests with the first one,
    in the reference controller's words; None if they agree."""
    items = list(subs.items())
    r0, first = items[0]
    for r, req in items[1:]:
        name = first.name
        if req.op_type != first.op_type:
            return (f"Mismatched collective operations: rank {r0} performs "
                    f"{first.op_type}, rank {r} performs {req.op_type} on "
                    f"tensor {name}.")
        if req.dtype != first.dtype:
            return (f"Mismatched data types: rank {r0} has {first.dtype}, "
                    f"rank {r} has {req.dtype} for tensor {name}.")
        if req.op_type in (ALLREDUCE, BROADCAST) and req.shape != first.shape:
            return (f"Mismatched {req.op_type} tensor shapes: rank {r0} has "
                    f"{list(first.shape)}, rank {r} has {list(req.shape)} "
                    f"for tensor {name}.")
        if req.op_type == BROADCAST and req.root != first.root:
            return (f"Mismatched broadcast root ranks: rank {r0} uses root "
                    f"{first.root}, rank {r} uses root {req.root} for "
                    f"tensor {name}.")
        if req.op_type in (ALLGATHER, ALLTOALL) and \
                req.shape[1:] != first.shape[1:]:
            return (f"Mismatched {req.op_type} tensor shapes: all dimensions "
                    f"except the first must match across ranks for tensor "
                    f"{name} (rank {r0}: {list(first.shape)}, rank {r}: "
                    f"{list(req.shape)}).")
        if (req.reduce_op, req.prescale, req.postscale) != \
                (first.reduce_op, first.prescale, first.postscale):
            return f"Mismatched reduction ops for tensor {name}."
    return None


def _nbytes(req: Request) -> int:
    return torch.Size(req.shape).numel() * \
        torch.empty((), dtype=getattr(torch, req.dtype)).element_size()


def _signature(req: Request) -> int:
    """The request's ``ComputeSignature``, as the engine stamps it."""
    return fr.compute_signature(req.name, _OP_CODES[req.op_type],
                                fr.dtype_code(req.dtype),
                                _REDUCE_KIND[req.reduce_op], req.shape,
                                req.root)


def _rows(req: Optional[Request]) -> int:
    if req is None:
        return 0
    return req.shape[0] if req.shape else 1


class EagerExecutor:
    """The negotiation thread and the launches of one initialized job:
    ``ctrl`` is the gloo control group, ``data`` the group the ops run
    on."""

    def __init__(self, ctrl, data, rank: int, size: int,
                 device: torch.device, store=None):
        self._ctrl, self._data = ctrl, data
        self.rank, self.size, self.device = rank, size, device
        self._cache_capacity = env_int("HOROVOD_CACHE_CAPACITY")
        self._params = TunedParams(
            cycle_time_ms=env_float("HOROVOD_CYCLE_TIME"),
            fusion_threshold_bytes=env_int("HOROVOD_FUSION_THRESHOLD"),
            low_latency_threshold_bytes=env_int(
                "HOROVOD_LOW_LATENCY_THRESHOLD"),
            cache_enabled=self._cache_capacity > 0)
        self._cycle_s = self._params.cycle_time_ms / 1e3
        self.params_round = 0  # the round whose end adopted the knobs
        self.serving_mode = env_bool("HOROVOD_SERVING_MODE")
        autotune = env_bool("HOROVOD_AUTOTUNE")
        self._sync = env_bool("HOROVOD_TUNE") or autotune
        self._staged: Optional[TunedParams] = None  # rank 0's next push
        self._pm = ParameterManager(
            self._params, True,
            warmup_samples=env_int("HOROVOD_AUTOTUNE_WARMUP_SAMPLES"),
            steps=env_int("HOROVOD_AUTOTUNE_STEPS"),
            sample_cycles=env_int("HOROVOD_AUTOTUNE_SAMPLE_CYCLES"),
            log_path=env_str("HOROVOD_AUTOTUNE_LOG")) \
            if autotune and rank == 0 else None
        self._cache = ResponseCache(self._cache_capacity)
        self._stall = StallInspector(
            env_float("HOROVOD_STALL_CHECK_TIME_SECONDS"),
            env_float("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"),
            env_bool("HOROVOD_STALL_CHECK_DISABLE"))
        self._log = get_logger("eager")
        self.timeline = Timeline()
        if rank == 0 and env_str("HOROVOD_TIMELINE"):
            self.timeline.start(env_str("HOROVOD_TIMELINE"),
                                env_bool("HOROVOD_TIMELINE_MARK_CYCLES"))
        # pulling idle ranks into a round (module docstring): the store,
        # rank 0's token naming this executor's keys (known to every rank
        # after the first round), the wait before a rank asks
        self._store = store if size > 1 and not self._stall.disabled \
            else None
        self._token = uuid.uuid4().hex if rank == 0 else None
        self._pull_token: Optional[str] = None
        self._pull_s = min(1.0, self._stall.warning_sec / 4)
        self._round_entered: Optional[float] = None
        self._stopped = threading.Event()
        self._cv = threading.Condition()
        self._new: List[Request] = []          # submitted, not yet told
        self._waiting: Dict[str, Handle] = {}  # submitted, not launched
        self._join: Optional[Handle] = None
        self._joined_at: Optional[float] = None  # wall time of the join
        self._counters: Dict[str, int] = {}
        self._stop = False
        self._failure: Optional[str] = None  # why the loop ended, if it failed
        # the negotiated state, the same on every rank: name -> {rank:
        # request} in order of first sight, and rank -> (round its join
        # was seen in, its join's wall time)
        self._table: Dict[str, Dict[int, Request]] = {}
        self._joined: Dict[int, tuple] = {}
        self._round = 0
        self._stream = None
        from horovod_tpu_torch.metrics.registry import get_registry
        reg = get_registry()
        self._g_queue = reg.gauge(
            "hvd_engine_queue_depth",
            help="tensors submitted and not yet launched")
        self._c_responses = reg.counter(
            "hvd_engine_responses_total",
            help="responses executed (fused batches count once)")
        self._c_fused = reg.counter(
            "hvd_engine_fused_tensors_total",
            help="tensors carried by fused responses")
        self._c_multi = reg.counter(
            "hvd_engine_fused_responses_total",
            help="responses that fused more than one tensor")
        self._c_express = reg.counter(
            "hvd_engine_low_latency_responses_total",
            help="responses that rode the serving-mode express lane")
        self._c_hits = reg.counter(
            "hvd_engine_cache_hits_total",
            help="response-cache hits in the coordination loop")
        self._c_misses = reg.counter(
            "hvd_engine_cache_misses_total",
            help="response-cache misses in the coordination loop")
        self._c_invalid = reg.counter(
            "hvd_engine_cache_invalidations_total",
            help="cached responses renegotiated after a field changed")
        self._c_stall = reg.counter(
            "hvd_engine_stall_warnings_total",
            help="stall-inspector warning scans that fired")
        self._c_stalled = reg.counter(
            "hvd_engine_stalled_tensors_total",
            help="tensors named in stall warnings")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-eager")
        self._thread.start()
        self._watchdog = None
        if self._store is not None:
            self._watchdog = threading.Thread(target=self._watch, daemon=True,
                                              name="hvd-eager-pull")
            self._watchdog.start()

    @property
    def _rec(self) -> fr.FlightRecorder:
        return fr.get_recorder()

    # -- naming and submission (caller's thread) ---------------------------

    def auto_name(self, prefix: str) -> str:
        """``prefix.noname.N``, N counting this prefix's unnamed ops: the
        same on every rank that submits in the same order."""
        with self._cv:
            c = self._counters.get(prefix, 0)
            self._counters[prefix] = c + 1
        return f"{prefix}.noname.{c}"

    def submit(self, name: str, op_type: str, tensor: torch.Tensor,
               **fields) -> Handle:
        """Queue one op; returns at once."""
        handle = Handle(name, tensor)
        if tensor.is_cuda:
            handle._ready = torch.cuda.Event()
            handle._ready.record(torch.cuda.current_stream(tensor.device))
        req = Request(name, op_type, _dtype_name(tensor.dtype),
                      tuple(tensor.shape), **fields)
        rec = self._rec
        with host_annotation(f"hvd_enqueue:{name}"), self._cv:
            if self._stop:
                raise HorovodInternalError(
                    self._failure or "horovod_tpu_torch is shut down")
            if rec.capacity:
                # before the request is visible to the thread, so the
                # ring's order is the lifecycle's (engine.cc:241)
                rec.record(fr.ENQUEUE, name, self._round,
                           _OP_CODES[op_type], fr.dtype_code(req.dtype),
                           _nbytes(req), fr.OK, _signature(req))
            if name in self._waiting:
                # the rejected submit's lifecycle closes here, rank-local
                rec.record(fr.DONE, name, -1, _OP_CODES[op_type],
                           fr.dtype_code(req.dtype), _nbytes(req),
                           fr.INVALID_ARGUMENT)
                raise HorovodInternalError(
                    f"tensor {name} is already being processed")
            self._waiting[name] = handle
            self._new.append(req)
            self._g_queue.set(len(self._waiting))
            self.timeline.start_activity(name, "QUEUE")
            self._cv.notify()
        return handle

    def join(self) -> int:
        """Block until every rank has joined; the rank that joined last."""
        handle = Handle(None)
        with self._cv:
            if self._join is not None:
                raise HorovodInternalError("this rank has already joined")
            self._join, self._joined_at = handle, time.time()
            self._cv.notify()
        handle._launched.wait()
        if handle._error:
            raise HorovodInternalError(handle._error)
        return handle._result

    def stop(self, timeout: float = 5.0) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._stopped.set()
        self._thread.join(timeout=timeout)
        if self._watchdog is not None:
            self._watchdog.join(timeout=timeout)
        self.timeline.stop()
        if self._pm is not None:
            self._pm.close()

    # -- the engine's knobs (caller's thread) ------------------------------

    def set_tuned_params(self, cycle_time_ms: Optional[float] = None,
                         fusion_threshold_bytes: Optional[int] = None,
                         cache_enabled: Optional[bool] = None,
                         low_latency_threshold_bytes: Optional[int] = None,
                         express_lane: Optional[bool] = None) -> None:
        """Push knobs (``None`` keeps a value; reference ``bindings.py:
        447-480``). Rank 0's push rides its message of the next round and
        every rank adopts it at the end of that round; other ranks' pushes
        are ignored (they adopt rank 0's). At world > 1 the push needs
        ``HOROVOD_TUNE`` or ``HOROVOD_AUTOTUNE`` on every rank."""
        if self.size > 1 and not self._sync:
            raise HorovodInternalError(
                "tuned-params push needs the per-round parameter exchange: "
                "set HOROVOD_TUNE=1 (or HOROVOD_AUTOTUNE=1) on every rank")
        given = {k: v for k, v in (
            ("cycle_time_ms", cycle_time_ms),
            ("fusion_threshold_bytes", fusion_threshold_bytes),
            ("cache_enabled", cache_enabled),
            ("low_latency_threshold_bytes", low_latency_threshold_bytes),
            ("express_lane", express_lane)) if v is not None}
        # the C API's sentinels: a cycle or a threshold <= 0 keeps it
        for k in ("cycle_time_ms", "fusion_threshold_bytes"):
            if given.get(k, 1) <= 0:
                del given[k]
        if self.rank != 0:
            return
        with self._cv:
            base = self._staged or self._params
            self._staged = dataclasses.replace(
                base, **{k: type(getattr(base, k))(v)
                         for k, v in given.items()})
            self._cv.notify()

    def tuned_params(self) -> dict:
        """The knobs in force (a push shows once its round has ended)."""
        return self._params.as_dict()

    def stall_report(self) -> Optional[dict]:
        """The last stall report (reference ``bindings.py:410-416``), or
        None before the first warning."""
        return self._stall.report()

    # -- the negotiation thread -------------------------------------------

    def _busy(self) -> bool:
        return bool(self._waiting or self._join or
                    (self._staged is not None and self.size == 1))

    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            self._stream = torch.cuda.Stream(self.device)
        try:
            while True:
                with self._cv:
                    while not (self._stop or self._busy()):
                        if self._store is None or self._pull_token is None:
                            self._cv.wait()
                        elif not self._cv.wait(timeout=self._pull_s):
                            self._cv.release()
                            try:
                                pulled = self._pulled()
                            finally:
                                self._cv.acquire()
                            if pulled:
                                break
                    if self._stop:
                        return
                    new, self._new = self._new, []
                    joined_at = self._joined_at
                    staged, self._staged = (self._staged, None) \
                        if self.rank == 0 else (None, None)
                rec, tl = self._rec, self.timeline
                for req in new if rec.capacity else ():
                    rec.record(fr.NEGOTIATE, req.name, self._round + 1,
                               _OP_CODES[req.op_type],
                               fr.dtype_code(req.dtype), _nbytes(req),
                               fr.OK, _signature(req))
                for req in new if tl.active else ():
                    tl.end_activity(req.name)
                    tl.start_activity(req.name, "NEGOTIATE")
                lead = self._lead(staged) if self.rank == 0 else None
                msgs: list = [None] * self.size
                self._round_entered = time.monotonic()
                dist.all_gather_object(msgs, (self._encode(new), joined_at,
                                              lead), group=self._ctrl)
                self._round_entered = None
                self._apply(msgs)
                with self._cv:
                    if (self._waiting or self._join) and not self._new \
                            and not self._stop:
                        self._cv.wait(timeout=self._cycle_s)
        # hvd-lint: disable=HVL003 - _fail_all hands the error to every waiter
        except Exception as err:  # noqa: BLE001 - fail every waiter, exit
            basics.note_failure(err)
            self._fail_all(f"eager negotiation failed: {err!r}")

    def _lead(self, staged: Optional[TunedParams]) -> tuple:
        """Rank 0's part of a round: its clock, the parameters every rank
        adopts at the round's end (a push, or the autotuner's choice when
        it differs from those in force) and the token of the pull keys."""
        params = staged
        if self._pm is not None and (self._pm.active or staged is None):
            params = self._pm.current if self._pm.current != self._params \
                else None
        return time.monotonic(), params, self._token

    def _encode(self, new: List[Request]) -> list:
        """This rank's new requests, each a cache position when the name
        was negotiated before with the same fields (a HIT)."""
        if not self._cache.capacity:
            return new
        out = []
        for req in new:
            state = self._cache.lookup(req.name, self.rank, req)
            if state == HIT:
                self._c_hits.inc()
                out.append(self._cache.position(req.name))
                continue
            (self._c_invalid if state == INVALID else self._c_misses).inc()
            out.append(req)
        return out

    def _decode(self, msgs) -> List[List[Request]]:
        """Every rank's requests of the round: positions resolved against
        the cache as it stood when they were encoded, then the cache
        touched for each hit and cleared of each name sent in full (an
        invalidation on every rank at once)."""
        reqs = [[self._cache.request(it, r) if isinstance(it, int) else it
                 for it in items] for r, (items, _, _) in enumerate(msgs)]
        for items, _, _ in msgs:
            for it in items:
                if isinstance(it, int):
                    self._cache.touch(it)
                else:
                    self._cache.erase(it.name)
        return reqs

    # -- pulling an idle rank into a round ----------------------------------

    def _pull_key(self, round_: int) -> str:
        return f"hvd_eager_pull/{self._pull_token}/{round_}"

    def _pulled(self) -> bool:
        """True when a rank waits in the next round for this idle one."""
        try:
            return self._store.check([self._pull_key(self._round + 1)])
        except Exception:  # noqa: BLE001 - a store gone: stay asleep
            return False

    def _watch(self) -> None:
        """Post the round this rank has waited in for ``_pull_s``."""
        posted = None
        while not self._stopped.wait(self._pull_s / 2):
            entered, round_ = self._round_entered, self._round + 1
            if entered is None or self._pull_token is None or \
                    posted == round_ or \
                    time.monotonic() - entered < self._pull_s:
                continue
            try:
                self._store.set(self._pull_key(round_), "1")
                posted = round_
            except Exception:  # noqa: BLE001 - a store gone: nothing to do
                return

    def _fail_all(self, message: str) -> None:
        fr.dump_to_env_dir("abort", message)
        with self._cv:
            waiting, self._waiting = self._waiting, {}
            join, self._join = self._join, None
            self._stop, self._failure = True, message
        for handle in list(waiting.values()) + ([join] if join else []):
            handle._finish(error=message)

    def _apply(self, msgs) -> None:
        """One round's requests and join flags, applied to the table; the
        ready ops launched, the join completed once everyone joined, the
        stall scan run and rank 0's parameters adopted."""
        self._round += 1
        self._rec.cycle = self._round
        tl = self.timeline
        tl.mark_cycle()
        now, params, token = msgs[0][2]
        self._pull_token = token
        for r, reqs in enumerate(self._decode(msgs)):
            for req in reqs:
                self._table.setdefault(req.name, {})[r] = req
                tl.rank_ready(req.name, r)
            joined_at = msgs[r][1]
            if joined_at is not None and r not in self._joined:
                self._joined[r] = (self._round, joined_at)
        ready = self._ready()
        for name, subs in ready:
            first = next(iter(subs.values()))
            if len(subs) == self.size and first.op_type != BARRIER and \
                    _check(subs) is None:
                self._cache.put(name, subs)
        batches = self._batches(ready)
        if batches or any(items for items, _, _ in msgs):
            # the clock anchor of a round every rank took part in
            self._rec.record(fr.CYCLE, "", self._round, fr.OP_NONE, -1, 0,
                             fr.OK, len(batches))
        moved = 0
        for batch in batches:
            moved += self._launch(batch)
        if self._pm is not None:
            self._pm.record_round(moved)
        if params is not None:
            self._adopt(params)
        self._scan(now)
        if len(self._joined) == self.size:
            # ranks whose joins a round saw together: the later wall time
            last = max(self._joined, key=lambda r: (self._joined[r], r))
            self._joined = {}
            with self._cv:
                join, self._join = self._join, None
                self._joined_at = None
            join._finish(result=last)

    def _adopt(self, params: TunedParams) -> None:
        """Rank 0's parameters, in force from the next round on."""
        if params.cache_enabled != self._params.cache_enabled:
            self._cache.set_capacity(self._cache_capacity
                                     if params.cache_enabled else 0)
        self._params = params
        self._cycle_s = params.cycle_time_ms / 1e3
        self.params_round = self._round

    def _scan(self, now: float) -> None:
        """The stall scan of the table at rank 0's clock ``now``."""
        message, stalled, shutdown = self._stall.scan(
            {n: subs.keys() for n, subs in self._table.items()},
            self._joined, self.size, now)
        if message is not None:
            self._c_stall.inc()
            self._c_stalled.inc(stalled)
            self._log.warning(message)
            fr.dump_to_env_dir("stall", json.dumps(self._stall.report()))
        if shutdown:
            self._fail_all(
                f"stalled eager ops passed HOROVOD_STALL_SHUTDOWN_TIME_"
                f"SECONDS ({self._stall.shutdown_sec:g} s): "
                f"{json.dumps(self._stall.report())}")

    def _ready(self) -> List[Tuple[str, Dict[int, Request]]]:
        """The ready ops, taken out of the table in table order."""
        present = [name for name, subs in self._table.items()
                   if all(r in subs or r in self._joined
                          for r in range(self.size))]
        counts: Dict[int, int] = {}
        for name in present:
            gid = next(iter(self._table[name].values())).group_id
            counts[gid] = counts.get(gid, 0) + 1
        out = []
        for name in present:
            first = next(iter(self._table[name].values()))
            if first.group_id < 0 or counts[first.group_id] >= \
                    first.group_size:
                out.append((name, self._table.pop(name)))
        return out

    def _batches(self, ready) -> List[list]:
        """Launch units in order: a fused run of allreduces of one (dtype,
        op, scales) up to the threshold, or one other op. A unit carries
        its check error instead when the ranks disagree."""
        batches: List[list] = []
        express: List[list] = []
        open_: Dict[tuple, list] = {}
        lane = self.serving_mode or self._params.express_lane
        threshold = self._params.fusion_threshold_bytes
        for name, subs in ready:
            error = _check(subs)
            first = next(iter(subs.values()))
            if lane and error is None and rules.express_eligible(
                    _nbytes(first), self._params.low_latency_threshold_bytes,
                    grouped=first.group_id >= 0,
                    data_bearing=first.op_type != BARRIER):
                # the express lane (controller.cc:263-313): alone, and
                # ahead of every bulk unit of the round
                express.append([(name, subs, None)])
                continue
            if error is None and first.op_type == ALLREDUCE and \
                    first.reduce_op != Adasum.value:
                key = (first.dtype, first.reduce_op, first.prescale,
                       first.postscale)
                nbytes = _nbytes(first)
                batch = open_.get(key)
                if batch is None or batch[0] + nbytes > threshold:
                    batch = open_[key] = [0]
                    batches.append(batch)
                batch[0] += nbytes
                batch.append((name, subs, None))
            else:
                batches.append([0, (name, subs, error)])
        if express:
            self._c_express.inc(len(express))
        return express + [b[1:] for b in batches]

    def _launch(self, batch) -> int:
        """Launch one unit; the bytes of this rank's data it moves."""
        with self._cv:
            handles = [self._waiting.pop(name, None) for name, _, _ in batch]
            self._g_queue.set(len(self._waiting))
        rec, cyc, tl = self._rec, self._round, self.timeline
        error = batch[0][2]
        if error is not None:
            # the negotiation's verdict on a mismatch (engine.cc:494)
            rec.record(fr.DESYNC, batch[0][0], cyc, fr.OP_ERROR, -1, 0,
                       fr.INVALID_ARGUMENT)
            if handles[0] is not None:
                tl.end_activity(batch[0][0])
                handles[0]._finish(error=error)
            return 0
        first = next(iter(batch[0][1].values()))
        self._c_responses.inc()
        self._c_fused.inc(len(batch))
        if len(batch) > 1:
            self._c_multi.inc()
        if tl.active:
            for (name, _, _), h in zip(batch, handles):
                if h is not None:
                    tl.end_activity(name)  # this rank's NEGOTIATE
                tl.start_activity(name, f"EXEC_{first.op_type.upper()}")
        op, dtype = _OP_CODES[first.op_type], fr.dtype_code(first.dtype)
        sizes = [_nbytes(next(iter(subs.values()))) for _, subs, _ in batch]
        exec_ts = None
        for (name, _, _), nbytes in zip(batch, sizes):
            rec.record(fr.FUSE, name, cyc, op, dtype, nbytes, fr.OK,
                       len(batch))
            exec_ts = rec.record(fr.EXEC, name, cyc, op, dtype, nbytes)
        t0 = time.perf_counter()
        try:
            # the span of the reference's engine callback: executing one
            # negotiated response on the data plane
            with host_annotation(f"hvd_engine_exec:{first.op_type}"):
                results, event, start = self._execute(first, batch, handles)
        except Exception as err:  # noqa: BLE001 - the op fails, not the loop
            for (name, _, _), nbytes in zip(batch, sizes):
                rec.record(fr.DONE, name, cyc, op, dtype, nbytes,
                           fr.UNKNOWN_ERROR,
                           int((time.perf_counter() - t0) * 1e6))
                tl.end_activity(name)
            basics.note_failure(err)
            for h in handles:
                if h is not None:
                    h._finish(error=f"{first.op_type} failed: {err!r}")
            return 0
        span = int((time.perf_counter() - t0) * 1e6)
        for name, _, _ in batch if tl.active else ():
            tl.end_activity(name)
        for (name, _, _), nbytes in zip(batch, sizes):
            # on the card the side stream may still run: the dump reads
            # the span from the CUDA events (flight_recorder.Deferred)
            rec.record(fr.DONE, name, cyc, op, dtype, nbytes, fr.OK,
                       span if start is None else
                       fr.Deferred(event, start, exec_ts))
        for h, (result, aux) in zip(handles, results):
            if h is not None:
                h._finish(result=result, event=event, aux=aux)
        return sum(sizes)

    def _execute(self, first: Request, batch, handles):
        """(each op's ``(result, aux)``, the completion event or None, the
        timing event recorded once the inputs are ready, or None)."""
        if self._stream is None:
            return self._run(first, batch, handles), None, None
        timed = self._rec.enabled
        with torch.cuda.stream(self._stream):
            for h in handles:
                if h is not None and h._ready is not None:
                    self._stream.wait_event(h._ready)
                    h._input.record_stream(self._stream)
            start = None
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record(self._stream)
            results = self._run(first, batch, handles)
            event = torch.cuda.Event(enable_timing=timed)
            event.record(self._stream)
        return results, event, start

    # -- the data plane (negotiation thread, on the side stream) -----------

    def _run(self, first: Request, batch, handles) -> list:
        """``(result, aux)`` of each op of ``batch`` on this rank."""
        run = {ALLREDUCE: self._allreduce, ALLGATHER: self._allgather,
               BROADCAST: self._broadcast, ALLTOALL: self._alltoall,
               BARRIER: lambda *_: [(None, None)]}[first.op_type]
        return run(first, batch, handles)

    def _input(self, handle, req: Request, op: Op) -> torch.Tensor:
        if handle is not None:
            return handle._input
        return identity_buffer(req.shape, getattr(torch, req.dtype), op,
                               self.device)

    def _allreduce(self, first, batch, handles) -> list:
        op = Op(first.reduce_op)
        # the frontend's activities inside the exec span, on the first
        # tensor's lane (reference common/eager.py:210-245)
        lane, tl = batch[0][0], self.timeline
        tl.start_activity(lane, "MEMCPY_IN_FUSION_BUFFER")
        xs = [self._input(h, next(iter(subs.values())), op)
              for h, (_, subs, _) in zip(handles, batch)]
        flat = torch.cat([x.reshape(-1) for x in xs]) if len(xs) > 1 \
            else xs[0].reshape(-1).clone()
        tl.end_activity(lane)
        tl.start_activity(lane, "COMMUNICATE_ALLREDUCE")
        flat = _scale(flat, first.prescale)
        if op is Adasum:
            if not flat.is_floating_point():
                raise ValueError(f"Adasum requires a floating-point dtype, "
                                 f"got {first.dtype}")
            gathered = flat.new_empty(self.size * flat.numel())
            basics.wait_work(dist.all_gather_into_tensor(
                gathered, flat, group=self._data, async_op=True))
            flat = _adasum_tree(gathered.view(self.size, -1).double()) \
                .to(flat.dtype)
        else:
            basics.wait_work(dist.all_reduce(
                flat, _DIST_OPS[op], group=self._data, async_op=True))
        if op is Average:
            flat = _scale(flat, 1.0 / self.size)
        flat = _scale(flat, first.postscale)
        tl.end_activity(lane)
        tl.start_activity(lane, "MEMCPY_OUT_FUSION_BUFFER")
        out, offset = [], 0
        for x in xs:
            out.append((flat[offset:offset + x.numel()].view(x.shape), None))
            offset += x.numel()
        tl.end_activity(lane)
        return out

    def _allgather(self, first, batch, handles) -> list:
        (_, subs, _), handle = batch[0], handles[0]
        rows = [_rows(subs.get(r)) for r in range(self.size)]
        trailing = first.shape[1:]
        dtype = getattr(torch, first.dtype)
        width = max(rows)
        if width == 0:
            out = torch.zeros((0, *trailing), dtype=dtype, device=self.device)
            return [(out, {"rank_sizes": rows})]
        send = torch.zeros((width, *trailing), dtype=dtype,
                           device=self.device)
        if handle is not None:
            x = handle._input
            send[:rows[self.rank]] = x.reshape(rows[self.rank], *trailing)
        gathered = send.new_empty((self.size * width, *trailing))
        basics.wait_work(dist.all_gather_into_tensor(
            gathered, send, group=self._data, async_op=True))
        out = torch.cat([gathered[r * width:r * width + n]
                         for r, n in enumerate(rows)])
        return [(out, {"rank_sizes": rows})]

    def _broadcast(self, first, batch, handles) -> list:
        handle = handles[0]
        buf = handle._input.clone(memory_format=torch.contiguous_format) \
            if handle is not None else torch.zeros(
            first.shape, dtype=getattr(torch, first.dtype),
            device=self.device)
        basics.wait_work(dist.broadcast(buf, src=first.root,
                                        group=self._data, async_op=True))
        return [(buf, None)]

    def _splits(self, req: Optional[Request]) -> List[int]:
        """The rows rank ``req``'s tensor sends to each rank."""
        if req is None:
            return [0] * self.size
        if req.splits is not None:
            if len(req.splits) != self.size or \
                    sum(req.splits) != _rows(req):
                raise ValueError(
                    f"alltoall splits {list(req.splits)} of tensor "
                    f"{req.name} must give {self.size} counts summing to "
                    f"its {_rows(req)} rows")
            return list(req.splits)
        if _rows(req) % self.size:
            raise ValueError(f"alltoall: the {_rows(req)} rows of tensor "
                             f"{req.name} do not split evenly over "
                             f"{self.size} ranks")
        return [_rows(req) // self.size] * self.size

    def _alltoall(self, first, batch, handles) -> list:
        (_, subs, _), handle = batch[0], handles[0]
        splits = [self._splits(subs.get(r)) for r in range(self.size)]
        send_splits = splits[self.rank]
        recv_splits = [s[self.rank] for s in splits]
        trailing = first.shape[1:]
        dtype = getattr(torch, first.dtype)
        send = handle._input.reshape(-1, *trailing).contiguous() \
            if handle is not None else \
            torch.zeros((0, *trailing), dtype=dtype, device=self.device)
        out = send.new_empty((sum(recv_splits), *trailing))
        basics.wait_work(dist.all_to_all_single(
            out, send, recv_splits, send_splits, group=self._data,
            async_op=True))
        return [(out, {"recv_splits": recv_splits})]


# ---------------------------------------------------------------------------
# the executor of the initialized job

_executor: Optional[EagerExecutor] = None
_executor_lock = threading.Lock()


def get_executor() -> Optional[EagerExecutor]:
    """The job's executor, started at first use; None before ``init()``
    (size-1 semantics)."""
    global _executor
    if not basics.is_initialized():
        return None
    with _executor_lock:
        if _executor is None:
            ctx = basics._ctx
            _executor = EagerExecutor(*ctx.eager_groups, ctx.rank, ctx.size,
                                      ctx.device, ctx.store)
        return _executor


def stop_executor(timeout: float = 5.0) -> None:
    """Stop the negotiation thread and join it for up to ``timeout``
    seconds (``shutdown()`` calls it)."""
    global _executor
    with _executor_lock:
        ex, _executor = _executor, None
    if ex is not None:
        ex.stop(timeout=timeout)


def _require_executor() -> EagerExecutor:
    ex = get_executor()
    if ex is None:
        raise ValueError("horovod_tpu_torch has not been initialized; "
                         "use hvd.init()")
    return ex


def set_tuned_params(**knobs) -> None:
    """Push the eager plane's knobs (:meth:`EagerExecutor.set_tuned_params`;
    the reference's ``EngineSession.set_tuned_params``)."""
    _require_executor().set_tuned_params(**knobs)


def tuned_params() -> dict:
    """The eager plane's knobs in force."""
    return _require_executor().tuned_params()


def stall_report() -> Optional[dict]:
    """This rank's last stall report (reference ``basics.stall_report``):
    ``{"stalled": [{"tensor", "ready", "missing", "waited_sec"}, ...],
    "warning_sec": N}``, or None before the first warning."""
    return _require_executor().stall_report()


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Start writing this rank's eager-op timeline to ``file_path``
    (reference ``basics.start_timeline``)."""
    _require_executor().timeline.start(file_path, mark_cycles)


def stop_timeline() -> None:
    """Close the timeline file."""
    _require_executor().timeline.stop()


def resolve_op(op, average) -> Op:
    """The legacy ``average=`` argument (reference eager.py:380-385)."""
    if average is not None:
        return Average if average else Sum
    return op if op is not None else Average


def _tensor(x) -> torch.Tensor:
    """``x`` as a tensor on the job's device."""
    device = basics.device() if basics.is_initialized() else None
    x = torch.as_tensor(x, device=device)
    return x.detach()


def _local(x: torch.Tensor, op: Op, prescale: float,
           postscale: float) -> torch.Tensor:
    """The size-1 allreduce: the input, scaled."""
    if op not in _DIST_OPS and op is not Adasum:
        raise ValueError(f"unknown op {op}")
    return _scale(_scale(x.clone(), prescale), postscale)


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0):
    op = resolve_op(op, average)
    x = _tensor(tensor)
    ex = get_executor()
    if ex is None:
        return LocalHandle(_local(x, op, prescale_factor, postscale_factor))
    if op not in _DIST_OPS and op is not Adasum:
        raise ValueError(f"unknown op {op}")
    return ex.submit(name or ex.auto_name("allreduce"), ALLREDUCE, x,
                     reduce_op=op.value, prescale=float(prescale_factor),
                     postscale=float(postscale_factor))


def grouped_allreduce_async(tensors: Sequence, average=None, name=None,
                            op=None, prescale_factor=1.0,
                            postscale_factor=1.0) -> list:
    op = resolve_op(op, average)
    xs = [_tensor(t) for t in tensors]
    ex = get_executor()
    if ex is None:
        return [LocalHandle(_local(x, op, prescale_factor, postscale_factor))
                for x in xs]
    base = name or ex.auto_name("grouped_allreduce")
    # the same on every process (Python's hash() is salted per process)
    gid = zlib.crc32(base.encode()) & 0x3fffffff
    return [ex.submit(f"{base}.{i}", ALLREDUCE, x, reduce_op=op.value,
                      prescale=float(prescale_factor),
                      postscale=float(postscale_factor), group_id=gid,
                      group_size=len(xs))
            for i, x in enumerate(xs)]


def allgather_async(tensor, name=None):
    x = _tensor(tensor)
    ex = get_executor()
    if ex is None:
        return LocalHandle(x.clone(), {"rank_sizes": [_rows_of(x)]})
    return ex.submit(name or ex.auto_name("allgather"), ALLGATHER, x)


def broadcast_async(tensor, root_rank, name=None):
    x = _tensor(tensor)
    ex = get_executor()
    if ex is None:
        return LocalHandle(x.clone())
    return ex.submit(name or ex.auto_name("broadcast"), BROADCAST, x,
                     root=int(root_rank))


def alltoall_async(tensor, splits=None, name=None):
    x = _tensor(tensor)
    splits = None if splits is None else tuple(int(s) for s in splits)
    ex = get_executor()
    if ex is None:
        return LocalHandle(x.clone(), {"recv_splits": list(
            splits) if splits is not None else [_rows_of(x)]})
    return ex.submit(name or ex.auto_name("alltoall"), ALLTOALL, x,
                     splits=splits)


def _rows_of(x: torch.Tensor) -> int:
    return x.shape[0] if x.dim() else 1


def barrier() -> None:
    """Return once every rank has reached its barrier (negotiated like any
    op)."""
    ex = get_executor()
    if ex is None:
        return
    synchronize(ex.submit(ex.auto_name("barrier"), BARRIER,
                          torch.zeros((), dtype=torch.uint8)))


def join() -> int:
    """Block until every rank has joined (reference eager.py:487-503).
    Until then this rank takes part in the others' ops with identity
    inputs. Returns the rank that joined last, or -1 at world size 1."""
    ex = get_executor()
    if ex is None:
        return -1
    last = ex.join()
    return -1 if ex.size == 1 else last


def poll(handle) -> bool:
    """True once the op has completed; never blocks."""
    if isinstance(handle, LocalHandle):
        return True
    if not handle._launched.is_set():
        return False
    return handle._event is None or handle._event.query()


def synchronize(handle, timeout: float = 0.0):
    """The op's output, on the device. ``timeout`` seconds (0: no bound)
    to wait for the negotiation; the caller's stream then waits on the
    op's completion event, so the host does not block on the card."""
    if isinstance(handle, LocalHandle):
        return handle.result
    with host_annotation(f"hvd_negotiate_wait:{handle.name}"):
        launched = handle._launched.wait(timeout if timeout > 0 else None)
    if not launched:
        raise HorovodInternalError(
            f"timed out after {timeout} s waiting for {handle.name}")
    if handle._error:
        raise HorovodInternalError(handle._error)
    result = handle._result
    if handle._event is not None:
        stream = torch.cuda.current_stream()
        stream.wait_event(handle._event)
        if result is not None:
            result.record_stream(stream)
    return result
