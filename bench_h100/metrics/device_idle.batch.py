"""The device: the share of the profiled slice in which no kernel, copy or
set ran, in %."""

from h100bench.layers import idle_pct


def read(ctx):
    return idle_pct(ctx)
