"""HVL004 clean: reads through the port's typed accessors; writes of a
child's environment stay allowed."""
import os

from horovod_tpu_torch.common.env import env_float, env_int, env_is_set


def typed_reads():
    return (env_float("HOROVOD_CYCLE_TIME"), env_int("HOROVOD_RANK"),
            env_is_set("HOROVOD_SIZE"))


def child_env(rank):
    env = dict(os.environ)
    env["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_LOCAL_RANK"] = str(rank)
    return env
