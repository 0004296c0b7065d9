"""HVL005 clean: registered names only, and a prefix of registered
names."""
from horovod_tpu_torch.common.env import env_float, env_int


def knobs():
    return env_float("HOROVOD_CYCLE_TIME"), env_int("HOROVOD_FUSION_THRESHOLD")


HELP = "HOROVOD_TUNE_* set the epochs and the budget"
