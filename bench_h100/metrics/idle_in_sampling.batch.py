"""The device idle while the scheduler samples or emits: the share of the
profiled slice in which no kernel, copy or set ran and the scheduler's
thread was in batched.sample or batched.emit, in %."""

from h100bench.program import idle_in_pct


def read(ctx):
    return idle_in_pct(ctx, ("batched.sample", "batched.emit"))
