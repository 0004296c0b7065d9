"""HVL002 trigger: rank-dependent if/else with divergent collective
sequences — both sides collect, but never in the same order."""
import torch.distributed as dist


def divergent(state, grad):
    if dist.get_rank() == 0:
        dist.all_reduce(grad)
        dist.broadcast(state, src=0)
    else:
        dist.broadcast(state, src=0)
        dist.all_reduce(grad)
    return state
