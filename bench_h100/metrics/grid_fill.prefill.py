"""engine/batched.py: the tokens of live rows over the rows launched, in
the window's steps that carry prefill rows (the batched.step span's
rows_real and rows_launched counters), in %."""

from h100bench.program import grid_fill_pct


def read(ctx):
    return grid_fill_pct(ctx)
