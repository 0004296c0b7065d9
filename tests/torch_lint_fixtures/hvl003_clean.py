"""HVL003 clean: handlers that re-raise, narrow, route the abort errors
out first, or wrap no collectives."""
import torch.distributed as dist

from horovod_tpu_torch.common.exceptions import HorovodInternalError


def reraises(grad):
    try:
        dist.all_reduce(grad)
    except Exception:
        cleanup()
        raise
    return grad


def narrow(grad):
    try:
        dist.all_reduce(grad)
    except ValueError:  # cannot catch DistBackendError
        return None
    return grad


def routed_first(objs):
    try:
        dist.all_gather_object(objs, 1)
    except (HorovodInternalError, dist.DistBackendError):
        raise
    except Exception:  # only usage errors reach here
        return None
    return objs


def explicit_recovery(grad):
    try:
        dist.all_reduce(grad)
    except HorovodInternalError:  # explicit = deliberate (elastic loop)
        return None
    return grad


def no_collectives():
    try:
        return open("/nonexistent").read()
    except Exception:
        return ""


def cleanup():
    pass
