"""engine/runner.py: wall ms per runner.step call that carries prefill
rows, over the window's calls."""

from h100bench.layers import mean_ms


def read(ctx):
    return mean_ms([s.wall_s for s in ctx.window_steps if s.bt > 1])
