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

Before ``init()`` the ops take their size-1 semantics (:class:`LocalHandle`),
as the reference's do without an engine.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.env import env_float, env_int
from horovod_tpu_torch.common.reduce_ops import (Adasum, Average, Max, Min,
                                                 Op, Product, Sum)
from horovod_tpu_torch.profiler.annotate import host_annotation

ALLREDUCE, ALLGATHER, BROADCAST, ALLTOALL, BARRIER = (
    "allreduce", "allgather", "broadcast", "alltoall", "barrier")

_DIST_OPS = {Sum: dist.ReduceOp.SUM, Average: dist.ReduceOp.SUM,
             Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX,
             Product: dist.ReduceOp.PRODUCT}


class HorovodInternalError(RuntimeError):
    """An eager op failed (reference ``common/exceptions.py``)."""


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


def _rows(req: Optional[Request]) -> int:
    if req is None:
        return 0
    return req.shape[0] if req.shape else 1


class EagerExecutor:
    """The negotiation thread and the launches of one initialized job:
    ``ctrl`` is the gloo control group, ``data`` the group the ops run
    on."""

    def __init__(self, ctrl, data, rank: int, size: int,
                 device: torch.device):
        self._ctrl, self._data = ctrl, data
        self.rank, self.size, self.device = rank, size, device
        self._cycle_s = env_float("HOROVOD_CYCLE_TIME") / 1e3
        self._threshold = env_int("HOROVOD_FUSION_THRESHOLD")
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
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-eager")
        self._thread.start()

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
        with host_annotation(f"hvd_enqueue:{name}"), self._cv:
            if self._stop:
                raise HorovodInternalError(
                    self._failure or "horovod_tpu_torch is shut down")
            if name in self._waiting:
                raise HorovodInternalError(
                    f"tensor {name} is already being processed")
            self._waiting[name] = handle
            self._new.append(req)
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

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5.0)

    # -- the negotiation thread -------------------------------------------

    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            self._stream = torch.cuda.Stream(self.device)
        try:
            while True:
                with self._cv:
                    while not (self._stop or self._waiting or self._join):
                        self._cv.wait()
                    if self._stop:
                        return
                    new, self._new = self._new, []
                    joined_at = self._joined_at
                msgs: list = [None] * self.size
                dist.all_gather_object(msgs, (new, joined_at),
                                       group=self._ctrl)
                self._apply(msgs)
                with self._cv:
                    if (self._waiting or self._join) and not self._new \
                            and not self._stop:
                        self._cv.wait(timeout=self._cycle_s)
        except Exception as err:  # noqa: BLE001 - fail every waiter, exit
            self._fail_all(f"eager negotiation failed: {err!r}")

    def _fail_all(self, message: str) -> None:
        with self._cv:
            waiting, self._waiting = self._waiting, {}
            join, self._join = self._join, None
            self._stop, self._failure = True, message
        for handle in list(waiting.values()) + ([join] if join else []):
            handle._finish(error=message)

    def _apply(self, msgs) -> None:
        """One round's requests and join flags, applied to the table; the
        ready ops launched, the join completed once everyone joined."""
        self._round += 1
        for r, (reqs, joined_at) in enumerate(msgs):
            for req in reqs:
                self._table.setdefault(req.name, {})[r] = req
            if joined_at is not None and r not in self._joined:
                self._joined[r] = (self._round, joined_at)
        for batch in self._batches(self._ready()):
            self._launch(batch)
        if len(self._joined) == self.size:
            # ranks whose joins a round saw together: the later wall time
            last = max(self._joined, key=lambda r: (self._joined[r], r))
            self._joined = {}
            with self._cv:
                join, self._join = self._join, None
                self._joined_at = None
            join._finish(result=last)

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
        open_: Dict[tuple, list] = {}
        for name, subs in ready:
            error = _check(subs)
            first = next(iter(subs.values()))
            if error is None and first.op_type == ALLREDUCE and \
                    first.reduce_op != Adasum.value:
                key = (first.dtype, first.reduce_op, first.prescale,
                       first.postscale)
                nbytes = torch.Size(first.shape).numel() * \
                    torch.empty((), dtype=getattr(torch, first.dtype)) \
                    .element_size()
                batch = open_.get(key)
                if batch is None or batch[0] + nbytes > self._threshold:
                    batch = open_[key] = [0]
                    batches.append(batch)
                batch[0] += nbytes
                batch.append((name, subs, None))
            else:
                batches.append([0, (name, subs, error)])
        return [b[1:] for b in batches]

    def _launch(self, batch) -> None:
        with self._cv:
            handles = [self._waiting.pop(name, None) for name, _, _ in batch]
        error = batch[0][2]
        if error is not None:
            if handles[0] is not None:
                handles[0]._finish(error=error)
            return
        first = next(iter(batch[0][1].values()))
        try:
            # the span of the reference's engine callback: executing one
            # negotiated response on the data plane
            with host_annotation(f"hvd_engine_exec:{first.op_type}"):
                results, event = self._execute(first, batch, handles)
        except Exception as err:  # noqa: BLE001 - the op fails, not the loop
            for h in handles:
                if h is not None:
                    h._finish(error=f"{first.op_type} failed: {err!r}")
            return
        for h, (result, aux) in zip(handles, results):
            if h is not None:
                h._finish(result=result, event=event, aux=aux)

    def _execute(self, first: Request, batch, handles):
        """(each op's ``(result, aux)``, the completion event or None)."""
        if self._stream is None:
            return self._run(first, batch, handles), None
        with torch.cuda.stream(self._stream):
            for h in handles:
                if h is not None and h._ready is not None:
                    self._stream.wait_event(h._ready)
                    h._input.record_stream(self._stream)
            results = self._run(first, batch, handles)
            event = torch.cuda.Event()
            event.record(self._stream)
        return results, event

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
        xs = [self._input(h, next(iter(subs.values())), op)
              for h, (_, subs, _) in zip(handles, batch)]
        flat = torch.cat([x.reshape(-1) for x in xs]) if len(xs) > 1 \
            else xs[0].reshape(-1).clone()
        flat = _scale(flat, first.prescale)
        if op is Adasum:
            if not flat.is_floating_point():
                raise ValueError(f"Adasum requires a floating-point dtype, "
                                 f"got {first.dtype}")
            gathered = flat.new_empty(self.size * flat.numel())
            dist.all_gather_into_tensor(gathered, flat, group=self._data)
            flat = _adasum_tree(gathered.view(self.size, -1).double()) \
                .to(flat.dtype)
        else:
            dist.all_reduce(flat, _DIST_OPS[op], group=self._data)
        if op is Average:
            flat = _scale(flat, 1.0 / self.size)
        flat = _scale(flat, first.postscale)
        out, offset = [], 0
        for x in xs:
            out.append((flat[offset:offset + x.numel()].view(x.shape), None))
            offset += x.numel()
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
        dist.all_gather_into_tensor(gathered, send, group=self._data)
        out = torch.cat([gathered[r * width:r * width + n]
                         for r, n in enumerate(rows)])
        return [(out, {"rank_sizes": rows})]

    def _broadcast(self, first, batch, handles) -> list:
        handle = handles[0]
        buf = handle._input.clone(memory_format=torch.contiguous_format) \
            if handle is not None else torch.zeros(
            first.shape, dtype=getattr(torch, first.dtype),
            device=self.device)
        dist.broadcast(buf, src=first.root, group=self._data)
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
        dist.all_to_all_single(out, send, recv_splits, send_splits,
                               group=self._data)
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
                                      ctx.device)
        return _executor


def stop_executor() -> None:
    """Stop the negotiation thread (``shutdown()`` calls it)."""
    global _executor
    with _executor_lock:
        ex, _executor = _executor, None
    if ex is not None:
        ex.stop()


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
