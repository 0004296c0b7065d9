"""Shared by the exchange's readers: NCCL's kernels in rank 0's trace, found
by name, and every other device operation."""

from portbench import devtrace


def split(trace):
    """(the union of NCCL kernels' intervals, that of every other device
    operation)."""
    nccl, other = [], []
    for op in trace.device:
        (nccl if "nccl" in op.name.lower() else other).append(
            (op.start, op.end))
    return devtrace.union(nccl), devtrace.union(other)
