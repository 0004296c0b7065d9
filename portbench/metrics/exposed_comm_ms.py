"""Exposed communication per traced step on rank 0's card: time in which an
NCCL kernel runs and no other device operation does."""

from portbench import devtrace
from portbench.metrics._nccl import split


def read(ctx):
    nccl, other = split(ctx.trace)
    if not nccl or ctx.traced_steps <= 0:
        return None
    exposed = devtrace.length(nccl) - devtrace.intersect_length(nccl, other)
    return exposed / 1e3 / ctx.traced_steps
