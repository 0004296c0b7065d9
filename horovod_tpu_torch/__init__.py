"""horovod_tpu_torch: the PyTorch + CUDA port of horovod_tpu.

The JAX package ``horovod_tpu`` is the reference; this package mirrors its
layout and never imports it (nor JAX). Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.

The user frontend, as in the reference's ``horovod_tpu.jax``::

    import horovod_tpu_torch as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
"""

from horovod_tpu_torch.common.basics import (cross_rank, cross_size, device,
                                             init, is_initialized,
                                             local_rank, local_size,
                                             num_replicas, rank, shutdown,
                                             size)
from horovod_tpu_torch.common.reduce_ops import (Adasum, Average, Max, Min,
                                                 Op, Product, Sum)
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.functions import (allgather_object, broadcast_object,
                                         broadcast_optimizer_state,
                                         broadcast_parameters)
from horovod_tpu_torch.mpi_ops import (HorovodInternalError, allgather,
                                       allgather_async, allreduce,
                                       allreduce_async, alltoall,
                                       alltoall_async, barrier, broadcast,
                                       broadcast_async, grouped_allreduce,
                                       grouped_allreduce_async, join, poll,
                                       synchronize)
from horovod_tpu_torch.optimizer import DistributedOptimizer


def metric_average(value, name=None):
    """``value`` averaged over every rank through the eager allreduce
    (reference ``jax/__init__.py:208-217``, the post-epoch pattern of
    ``examples/pytorch/pytorch_mnist.py``)."""
    return allreduce(value, op=Average, name=name or "metric_average")


__all__ = ["init", "shutdown", "is_initialized", "rank", "size",
           "local_rank", "local_size", "cross_rank", "cross_size", "device",
           "num_replicas", "Op", "Average", "Sum", "Min", "Max", "Product",
           "Adasum", "Compression", "DistributedOptimizer",
           "broadcast_parameters", "broadcast_optimizer_state",
           "broadcast_object", "allgather_object", "metric_average",
           "allreduce", "allreduce_async", "grouped_allreduce",
           "grouped_allreduce_async", "allgather", "allgather_async",
           "broadcast", "broadcast_async", "alltoall", "alltoall_async",
           "barrier", "join", "poll", "synchronize", "HorovodInternalError"]
