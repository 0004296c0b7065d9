"""HVL003 trigger: broad except swallowing a collective failure."""
import torch.distributed as dist

import horovod_tpu_torch as hvd


def swallow(grad):
    try:
        dist.all_reduce(grad)
    except Exception:  # eats DistBackendError, strands peers
        return None
    return grad


def swallow_bare(handle):
    try:
        return hvd.synchronize(handle)
    except:  # noqa: E722 — bare except, same problem
        return None


def half_routed(objs):
    try:
        dist.all_gather_object(objs, 1)
    except dist.DistBackendError:
        raise
    except Exception:  # HorovodInternalError still swallowed
        return None
    return objs
