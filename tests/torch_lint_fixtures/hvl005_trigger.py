"""HVL005 trigger: HOROVOD_* names the port's registry does not declare."""
from horovod_tpu_torch.common.env import env_float


def misspelled():
    return env_float("HOROVOD_CYLE_TIME")  # typo: suggests the real name


def unknown(env):
    env["HOROVOD_TOTALLY_MADE_UP_KNOB"] = "1"  # no near neighbour
    return env


HELP = "HOROVOD_NOSUCHFAMILY_* set the knobs"  # a prefix of nothing
