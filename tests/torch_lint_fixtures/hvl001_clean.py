"""HVL001 clean: every rank issues the same collectives; rank conditions
only pick what a rank does with the result, and point-to-point calls
(a subset of ranks by design) stay out."""
import torch.distributed as dist

import horovod_tpu_torch as hvd


def all_ranks(grad, state):
    dist.all_reduce(grad)
    hvd.broadcast_parameters(state, root_rank=0)
    if hvd.rank() == 0:
        print("reduced", grad)
    return grad


def ring_step(buf, peer):
    if dist.get_rank() % 2 == 0:
        dist.send(buf, peer)
    else:
        dist.recv(buf, peer)
    return buf
