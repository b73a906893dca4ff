"""The whole step carrying prefill rows: the bound of its work (its 512 or
more tokens reach every expert) over its wall time, over the window's
steps, in %."""

from h100bench.layers import step_mfu_pct


def read(ctx):
    return step_mfu_pct(ctx, [s for s in ctx.window_steps if s.bt > 1])
