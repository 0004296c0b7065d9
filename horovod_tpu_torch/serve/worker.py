"""Per-process serving worker (``python -m horovod_tpu_torch.serve.worker``).

Counterpart of ``horovod_tpu/serve/worker.py``. :class:`ServeWorker` is
copied (host code); the heartbeat is a ``torch.distributed`` allreduce
where the reference has an engine session. Each worker:

1. rendezvouses through the elastic handshake (READY/go barrier,
   :mod:`horovod_tpu_torch.runner.elastic.worker`, inside ``init()``) when
   driver-spawned;
2. boots a local continuous-batching serving stack (batcher -> serving
   loop -> HTTP frontend) and **registers its endpoint** in the rendezvous
   KV under ``serve_addr/<host>/<local_rank>``, which the driver
   aggregates into ``serve_targets`` for the ingress router's
   :meth:`~horovod_tpu_torch.serve.router.RequestRouter.refresh_from_kv`;
3. when the job has peers, exchanges a small **heartbeat allreduce**
   (:class:`EngineHeartbeat`) between decode steps, on the eager data
   plane's group and bounded by the groups' timeout: a peer death surfaces
   as ``HorovodInternalError``;
4. on a generation change (driver notify key, or a failed heartbeat) it
   **drains instead of dropping**: accepted requests finish, the groups are
   torn down, and the worker re-rendezvouses and re-registers under the
   new generation, or drains and exits cleanly if its slot was removed;
5. exits 0 when the KV publishes ``serve_stop`` (job teardown).

The default model is the numpy toy step (instant startup); ``--model tp``
boots the TP LM on this process's card (a model axis of one) with the int8
activation wire.
"""

from __future__ import annotations

import argparse
import logging
import socket
import sys
import time
from datetime import timedelta
from typing import Optional, Tuple

from horovod_tpu_torch.common import kv_keys
from horovod_tpu_torch.common.env import (env_bool, env_float, env_int,
                                          env_is_set, env_str)
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.serve.batcher import ContinuousBatcher
from horovod_tpu_torch.serve.executor import ServingLoop, make_toy_step
from horovod_tpu_torch.serve.frontend import ServeFrontend

HB_INTERVAL_SEC = 0.25
POLL_INTERVAL_SEC = 0.05
# serve_stop / resize notifications are HTTP round trips against the one
# rendezvous KV server every worker shares — poll them at heartbeat-ish
# cadence, not the loop tick (40 req/s/worker of pure polling otherwise)
KV_POLL_INTERVAL_SEC = 1.0


class EngineHeartbeat:
    """Small-tensor liveness collective between serving peers.

    One 16-element fp32 allreduce (64 bytes) per interval on the eager data
    plane's group (``common/eager.py``: apart from the default group, so it
    never interleaves with a TP step's collectives, which run on the
    serving loop's thread), bounded by the groups' timeout. Failure means a
    peer died or aborted: :meth:`beat` raises ``HorovodInternalError`` and
    the caller tears the job's groups down (``shutdown()``) and
    re-rendezvouses. Needs ``horovod_tpu_torch.init()``."""

    def __init__(self, generation: int):
        from horovod_tpu_torch.common import basics
        self._basics = basics
        self._group = basics._ctx.eager_groups[1]
        self._device = basics.device()
        self._gen = generation

    def beat(self, timeout: Optional[float] = None):
        """One heartbeat collective; raises HorovodInternalError on peer
        failure or after ``timeout`` seconds (default the groups' timeout,
        ``HOROVOD_GLOO_TIMEOUT_SECONDS``)."""
        import torch
        import torch.distributed as dist
        wait = timedelta(seconds=timeout if timeout is not None
                         else env_float("HOROVOD_GLOO_TIMEOUT_SECONDS"))
        buf = torch.ones(16, dtype=torch.float32, device=self._device)
        with self._basics.translate_failures():
            work = dist.all_reduce(buf, group=self._group, async_op=True)
            if not work.wait(wait):
                raise RuntimeError(f"heartbeat collective timed out after "
                                   f"{wait} (generation {self._gen})")


class ServeWorker:
    """Local serving stack + KV registration for one process."""

    def __init__(self, step_fn=None, port: Optional[int] = None,
                 batcher: Optional[ContinuousBatcher] = None,
                 admission=None, vocab: Optional[int] = None):
        from horovod_tpu_torch.serve.admission import controller_from_env
        if batcher is None:
            # the serving fast path: a block-paged KV cache owned by the
            # batcher (admission charges its bounded pool) and, when
            # HOROVOD_SERVE_SPEC_DECODE is on, draft-model speculative
            # decoding over the cached toy model
            from horovod_tpu_torch.serve.kv_cache import PagedKVCache
            batcher = ContinuousBatcher(cache=PagedKVCache(), vocab=vocab)
        self.batcher = batcher
        cached = draft = None
        if step_fn is None and self.batcher.cache is not None:
            from horovod_tpu_torch.serve.executor import make_toy_cached_step
            cached = make_toy_cached_step()
            if env_bool("HOROVOD_SERVE_SPEC_DECODE"):
                draft = make_toy_cached_step()
        self.loop = ServingLoop(step_fn or make_toy_step(), self.batcher,
                                cached_step=cached, draft_step=draft)
        # SLO-aware admission: priority-class shedding + tenant quotas
        # (env-configured; the defaults are backwards-compatible — an
        # unprioritized request is only ever shed by the full queue)
        self.admission = admission if admission is not None \
            else controller_from_env()
        self.frontend = ServeFrontend(
            batcher=self.batcher,
            admission=self.admission,
            port=port if port is not None
            else (env_int("HOROVOD_SERVE_PORT") or 0))
        self._log = logging.getLogger("horovod_tpu_torch.serve.worker")
        self._kv = None

    def start(self) -> "ServeWorker":
        self.loop.start()
        self.frontend.start()
        return self

    def stop(self):
        self.loop.stop()
        self.frontend.stop()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Flip health to draining and finish everything accepted."""
        self.frontend.set_draining(True)
        drained = self.loop.drain(timeout)
        if not drained:
            self._log.warning("drain timed out with work still in flight")
        return drained

    # -- KV registration -----------------------------------------------------

    def _slot(self):
        return (env_str("HOROVOD_HOSTNAME", socket.gethostname()),
                str(env_int("HOROVOD_LOCAL_RANK")))

    def register(self, kv_client, generation: int):
        """Publish this worker's endpoint for the driver's serve_targets
        aggregation (exporter._publish_endpoint pattern)."""
        self._kv = kv_client
        host, local_rank = self._slot()
        addr = "127.0.0.1" if host == "localhost" else host
        kv_client.put_json(
            kv_keys.serve_addr(host, local_rank),
            {"id": f"{host}/{local_rank}", "addr": addr,
             "port": self.frontend.port, "rank": env_int("HOROVOD_RANK"),
             "generation": generation}, timeout=5.0)
        self._log.info("registered serve endpoint :%d (generation %d)",
                       self.frontend.port, generation)

    def deregister(self):
        if self._kv is None:
            return
        host, local_rank = self._slot()
        try:
            self._kv.delete(kv_keys.serve_addr(host, local_rank))
        except Exception:  # noqa: BLE001 — KV may already be gone at exit
            pass


def _build_step(model: str, compression: Optional[str], device):
    if model == "tp":
        # this process's card alone: the model axis of one, whose int8
        # wire is the codec's two round trips (executor.TpLm)
        from horovod_tpu_torch.serve.executor import make_tp_lm_step
        step_fn, _ = make_tp_lm_step(
            compression=compression
            if compression is not None
            else env_str("HOROVOD_SERVE_ACT_COMPRESSION"),
            device=device, axis=None)
        return step_fn
    # None -> ServeWorker's default stack: the cached toy model behind
    # the block-paged KV cache (+ speculative decode when enabled)
    return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="hvd-serve-worker")
    parser.add_argument("--model", choices=("toy", "tp"), default="toy")
    parser.add_argument("--compression", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device of the TP model and the "
                             "heartbeat (default cuda:local_rank)")
    args = parser.parse_args(argv)

    log = logging.getLogger("horovod_tpu_torch.serve.worker")
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.runner.elastic import preempt
    from horovod_tpu_torch.runner.elastic import worker as elastic_worker

    # Preemption notices (SIGTERM by default) drain a serve worker the
    # same way they drain a training worker: announce on the KV, finish
    # everything accepted, record DRAINED, exit 0.
    preempt.install_preempt_handler()

    elastic = elastic_worker.is_elastic_worker()
    kv = elastic_worker.kv_client() \
        if env_is_set("HOROVOD_RENDEZVOUS_ADDR") else None

    def join() -> Tuple[int, Optional[EngineHeartbeat]]:
        """(generation, heartbeat): an elastic worker joins the driver's
        generation (``init()`` runs the READY/go rendezvous), a static job
        with peers its process groups; a lone static worker needs none."""
        if not elastic and env_int("HOROVOD_SIZE") <= 1:
            return 0, None
        basics.init(device=args.device)
        gen = elastic_worker.current_generation() if elastic else 0
        return gen, EngineHeartbeat(gen) if basics.size() > 1 else None

    generation, hb = join()
    if elastic:
        # driver-recovery adoption + headless outage accounting
        elastic_worker.start_heartbeat()

    step_fn = _build_step(args.model, args.compression, args.device)
    worker = ServeWorker(step_fn, port=args.port,
                         vocab=getattr(step_fn, "vocab", None)).start()
    if kv is not None:
        worker.register(kv, generation)

    last_beat = 0.0
    last_kv_poll = 0.0
    try:
        while True:
            time.sleep(POLL_INTERVAL_SEC)
            now = time.monotonic()
            if preempt.preempt_requested():
                # the handler already announced the drain on the KV; we
                # finish what we accepted, then depart cleanly
                log.info("preemption notice: draining and exiting")
                worker.drain(timeout=30.0)
                worker.deregister()
                if elastic:
                    try:
                        elastic_worker.record_state(
                            generation, elastic_worker.DRAINED, kv)
                    except Exception:  # noqa: BLE001 — exit 0 still says
                        pass  # clean
                return 0
            kv_due = kv is not None and \
                now - last_kv_poll >= KV_POLL_INTERVAL_SEC
            if kv_due:
                last_kv_poll = now
                if kv.get_json(kv_keys.serve_stop(), timeout=1.0) is not None:
                    log.info("serve_stop published; draining and exiting")
                    worker.drain(timeout=30.0)
                    if elastic:
                        elastic_worker.record_state(
                            generation, elastic_worker.SUCCESS, kv)
                    return 0
            reset_needed = False
            heartbeat_failed = False
            if hb is not None and now - last_beat >= HB_INTERVAL_SEC:
                last_beat = now
                try:
                    hb.beat()
                except HorovodInternalError as e:
                    # peer death/abort. Keep serving what we accepted;
                    # rejoin the next generation (elastic) or exit loudly
                    # (static).
                    log.warning("heartbeat collective failed (%s)", e)
                    reset_needed = heartbeat_failed = True
            if elastic and not reset_needed and kv_due:
                new_gen = elastic_worker.poll_notification(kv)
                reset_needed = new_gen is not None
            if reset_needed:
                if basics.is_initialized():
                    basics.shutdown()
                hb = None
                if not elastic:
                    # no rendezvous to rejoin: a static job cannot heal —
                    # finish what we accepted, then fail loudly so the
                    # launcher sees a dead worker instead of a silent
                    # heartbeat-retry spin
                    log.error("peer failure in a static job; draining "
                              "and exiting")
                    worker.drain(timeout=30.0)
                    worker.deregister()
                    return 1
                if heartbeat_failed:
                    elastic_worker.request_new_generation()
                try:
                    generation, hb = join()
                except SystemExit:
                    # this slot was removed: drain instead of dropping
                    log.info("slot removed at resize; draining")
                    worker.drain(timeout=30.0)
                    worker.deregister()
                    return 0
                worker.register(kv, generation)
    finally:
        worker.stop()
        if basics.is_initialized():
            basics.shutdown()


if __name__ == "__main__":
    sys.exit(main())
