"""File-level suppression fixture."""
# hvd-lint: disable-file=HVL004
import os


def raw_reads():
    return os.environ.get("HOROVOD_RANK"), os.getenv("HOROVOD_SIZE")
