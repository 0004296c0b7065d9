"""The flash forward kernel's least time over its mean time in the
trace."""

from portbench.metrics._flash import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("flash_fwd",))
