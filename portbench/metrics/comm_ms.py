"""NCCL kernel time per traced step on rank 0's card (all of it, hidden or
not)."""

from portbench import devtrace
from portbench.metrics._nccl import split


def read(ctx):
    nccl, _ = split(ctx.trace)
    if not nccl or ctx.traced_steps <= 0:
        return None
    return devtrace.length(nccl) / 1e3 / ctx.traced_steps
