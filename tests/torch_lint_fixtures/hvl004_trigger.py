"""HVL004 trigger: direct environment reads of HOROVOD_* names."""
import os


def raw_reads():
    a = os.environ.get("HOROVOD_CYCLE_TIME")
    b = os.environ["HOROVOD_RANK"]
    c = "HOROVOD_SIZE" in os.environ
    d = os.getenv("HOROVOD_LOCAL_RANK")
    return a, b, c, d
