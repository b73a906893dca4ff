"""Kernels 4-6 in pure-decode steps: the bound of the routed experts' work
(h100bench/work.py: every expert's GGUF bytes, since the step's slots reach
all of them but with negligible chance, and 2 x slots x K x N operations)
over those kernels' device time in the profiled slice, in %."""

from h100bench.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, [s for s in ctx.traced_steps() if s.bt == 1],
                        ("experts",), {4, 5, 6})
