"""Suppression-comment fixture: the same patterns as the triggers, each
silenced by an explicit, reviewable hvd-lint comment."""
import os

import torch.distributed as dist


def checkpoint_restore(state):
    # deliberate: restore-then-broadcast happens before peers init
    if dist.get_rank() == 0:
        dist.broadcast(state, src=0)  # hvd-lint: disable=HVL001
    return state


def tolerated(grad):
    try:
        dist.all_reduce(grad)
    # hvd-lint: disable=HVL003 - benchmark probe, failure means skip
    except Exception:
        return None
    return grad


def raw_read():
    # hvd-lint: disable=HVL004,HVL005 - bootstrap probe of a foreign name
    return os.environ.get("HOROVOD_NOT_OURS")
