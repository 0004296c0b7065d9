"""The share of the traced window in which no operation runs on rank 0's
card: one less the union of the device operations' intervals over the
window's length."""

from portbench import devtrace


def read(ctx):
    busy, window = devtrace.busy_idle_us(ctx.trace)
    if window <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
