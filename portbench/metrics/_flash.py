"""Shared by the flash kernels' roofline readers: a kernel's least time at
the cell's shapes (``portbench.flops.kernel_bounds``) over its mean time in
the trace. The kernels are found by name; their number has to equal the
launches the program counted (``launch_counts()``) in the traced steps, or
nothing is read."""

from portbench import devtrace
from portbench.flops import kernel_bounds

# the flash kernels' names in a trace, by the program's counter's name
PATTERNS = {"flash_fwd": ("flash_fwd",),
            "flash_bwd_dq": ("flash_bwd_dq",),
            "flash_bwd_dkv": ("flash_bwd_dkv",)}


def roofline_pct(ctx, kernels):
    """100 x the sum of ``kernels``' bounds per launch over the sum of
    their mean times; None where a kernel did not run or its launches in
    the trace are not the counted ones."""
    s, tr = ctx.shape, ctx.traffic
    bounds = kernel_bounds(tr["batch_per_rank"], tr["seq_len"], s["heads"],
                           s["head_dim"], s["causal"],
                           ctx.config["run"]["dtype"], dv=s["v_head_dim"])
    bound_ms = mean_ms = 0.0
    for name in kernels:
        ops = devtrace.matching(ctx.trace, PATTERNS[name])
        if not ops or len(ops) != ctx.flash_launches.get(name):
            return None
        bound_ms += bounds[name][0]
        mean_ms += sum(op.end - op.start for op in ops) / len(ops) / 1e3
    return 100.0 * bound_ms / mean_ms
