"""The device idle while the runner packs its inputs or launches its graph:
the share of the profiled slice in which no kernel, copy or set ran and
the scheduler's thread was in runner.inputs or runner.replay, in %."""

from h100bench.program import idle_in_pct


def read(ctx):
    return idle_in_pct(ctx, ("runner.inputs", "runner.replay"))
