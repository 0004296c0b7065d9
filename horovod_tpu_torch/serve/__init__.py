"""Online inference serving plane (counterpart of ``horovod_tpu/serve``).

- :mod:`~horovod_tpu_torch.serve.batcher` — continuous-batching admission:
  bounded queue with backpressure, per-request deadlines, length buckets
  shared with the flash-attention router;
- :mod:`~horovod_tpu_torch.serve.executor` — the decode loop, the
  tensor-parallel LM on the card (its row-parallel reductions on the int8
  activation wire) and the fast path's recurrent LM;
- :mod:`~horovod_tpu_torch.serve.kv_cache` — the block-paged state cache
  with hash-based prefix reuse;
- :mod:`~horovod_tpu_torch.serve.router` — request routing over the
  elastic rendezvous KV: least-loaded placement, generation-change
  re-routing, drain-on-death with no silent loss of accepted requests;
- :mod:`~horovod_tpu_torch.serve.frontend` — stdlib HTTP ingress
  (``POST /v1/generate``, ``GET /healthz``, ``GET /stats``) and the port's
  ``hvd-serve``;
- :mod:`~horovod_tpu_torch.serve.worker` — the per-process serving worker
  the elastic driver spawns;
- :mod:`~horovod_tpu_torch.serve.loadgen` — open-loop load generation;
- :mod:`~horovod_tpu_torch.serve.admission` — priority classes and
  per-tenant token-bucket quotas in front of the batcher.

The reference's ``autoscale_smoke`` waits for the launcher's autoscaler.
Importing this package builds nothing and touches no device.
"""

from horovod_tpu_torch.serve.admission import (  # noqa: F401
    AdmissionController,
    TokenBucket,
    parse_priority_classes,
)
from horovod_tpu_torch.serve.batcher import (  # noqa: F401
    AdmissionRejected,
    ContinuousBatcher,
    InferenceRequest,
    bucket_for,
    bucket_plan,
    default_buckets,
)
from horovod_tpu_torch.serve.executor import (  # noqa: F401
    CachedStep,
    ServingLoop,
    TpLm,
    TpLmStep,
    activation_wire_report,
    make_rnn_lm_step,
    make_toy_cached_step,
    make_toy_draft_step,
    make_toy_step,
    make_tp_lm_step,
)
from horovod_tpu_torch.serve.kv_cache import (  # noqa: F401
    CacheExhausted,
    CacheLease,
    PagedKVCache,
    blocks_for,
    prefix_hash,
)
from horovod_tpu_torch.serve.frontend import ServeFrontend  # noqa: F401
from horovod_tpu_torch.serve.router import (  # noqa: F401
    NoWorkersError,
    RequestRouter,
    WorkerHandle,
)
