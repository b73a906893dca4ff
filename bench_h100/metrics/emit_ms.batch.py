"""engine/batched.py: mean ms a window step spends in batched.emit
(detokenizing, stop strings, the handles' events, finishing and its
callbacks), the profiled slice left out."""

from h100bench.program import phase_ms


def read(ctx):
    return phase_ms(ctx, "batched.emit")
