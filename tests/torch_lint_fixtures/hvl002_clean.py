"""HVL002 clean: both branches of a rank-dependent if/else issue the same
collective sequence."""
import torch.distributed as dist


def same_order(state, grad, scale):
    if dist.get_rank() == 0:
        dist.all_reduce(grad)
        dist.broadcast(state, src=0)
    else:
        grad.mul_(scale)
        dist.all_reduce(grad)
        dist.broadcast(state, src=0)
    return state
