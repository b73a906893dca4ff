"""Kernels 1-3 and the MoE kernels (5-6 at these slot counts) in steps
carrying prefill rows: the bound of the dense products', the head's and the
routed experts' work over those kernels' device time, in %."""

from h100bench.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, [s for s in ctx.traced_steps() if s.bt > 1],
                        ("dense", "head", "experts"), {1, 2, 3, 4, 5, 6})
