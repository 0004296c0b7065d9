"""HVL001 trigger: collectives reachable only under rank conditions."""
import torch.distributed as dist

import horovod_tpu_torch as hvd


def guarded_all_reduce(grad):
    if dist.get_rank() == 0:
        dist.all_reduce(grad)  # only rank 0 submits


def early_exit(state):
    if hvd.local_rank() != 0:
        return None
    return hvd.allreduce(state)  # subset of ranks reaches this


def while_rank(state):
    while hvd.rank() < 2:
        state = hvd.allgather(state)
    return state
