"""The flash backward kernels, dq and dk/dv together: the sum of their least
times over the sum of their mean times in the trace."""

from portbench.metrics._flash import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("flash_bwd_dq", "flash_bwd_dkv"))
