"""The whole pure-decode step: the bound of its work (every expert's bytes,
as in moe_roofline.decode) over its wall time, over the window's steps, in
%."""

from h100bench.layers import step_mfu_pct


def read(ctx):
    return step_mfu_pct(ctx, [s for s in ctx.window_steps if s.bt == 1])
