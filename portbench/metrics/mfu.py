"""The train step's share of the card's peak: model FLOPs of the window's
steps, counted from the configuration's shapes (``portbench.flops``), over
the window's seconds and the card's dense peak in the configuration's
compute type."""

from portbench.flops import peak_flops


def read(ctx):
    peak = peak_flops(ctx.card, ctx.config["run"]["dtype"])
    if peak is None or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.step_flops * ctx.window_steps / ctx.window_s / peak
