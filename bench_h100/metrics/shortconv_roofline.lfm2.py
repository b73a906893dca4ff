"""The short-conv kernel (csrc/shortconv.cu, named short_conv_kernel on
the device trace): the bound of its work in the traced steps
(reference/lfm2moe.shortconv_work: 2 x taps x tokens x H operations; the
float32 bytes it moves: B.x in and output out, each real row's window
read and written, the taps) over its device time there, in %. The kernel's ops are
attributed to each step's bench.step.N note from the trace itself, as
h100bench.layers.Context does for kernels 1-6; a program without the
kernel gives nothing to read."""

from h100bench.work import Work

KERNEL = "short_conv_kernel"


def read(ctx):
    t = ctx.trace
    work = getattr(ctx.work.family, "shortconv_work", None)
    if t is None or work is None:
        return None
    notes = sorted((a, b, int(n.rsplit(".", 1)[1])) for n, a, b in t.notes
                   if n.startswith("bench.step."))
    ops = sorted((o for o in t.ops if KERNEL in o[0]), key=lambda o: o[1])
    bound = dev = 0.0
    i = 0
    for a, b, idx in notes:
        while i < len(ops) and ops[i][1] < a:
            i += 1
        d = 0.0
        while i < len(ops) and ops[i][1] <= b:
            d += (ops[i][2] - ops[i][1]) / 1e6
            i += 1
        if d > 0.0 and idx < len(ctx.steps):
            bound += Work(*work(ctx.work.cfg, ctx.steps[idx].rows)).bound_s
            dev += d
    return 100.0 * bound / dev if dev > 0.0 else None
