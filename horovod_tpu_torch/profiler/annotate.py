"""Trace annotations: named spans in ``torch.profiler`` and NVTX traces.

Counterpart of ``horovod_tpu/profiler/annotate.py``. The reference names
in-jit collectives with ``jax.named_scope`` and host work with
``jax.profiler.TraceAnnotation``; here both are host-side spans, since the
port issues every collective from Python:

- :func:`collective_scope` — ``torch.profiler.record_function`` around a
  collective of ``parallel/collectives.py`` (``hvd_allreduce_sum``,
  ``hvd_alltoall``, ...), and on a machine with CUDA also an NVTX range,
  so that Nsight Systems shows the same span over the NCCL kernel.
- :func:`host_annotation` — ``record_function`` around the eager ops' host
  work (``common/eager.py``: enqueue, execution, the wait for
  negotiation).

Both cost a few microseconds when no profiler is collecting.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def collective_scope(name: str):
    """Name the enclosed collective in the profiler trace (and NVTX)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def host_annotation(name: str):
    """Annotate a host-side span in the ``torch.profiler`` trace."""
    return torch.profiler.record_function(name)
