"""grid_fill.prefill's reading over this cell: the tokens of live rows over
the rows launched, in the window's steps that carry prefill rows, in %.
Beside it, on stderr: the rows whose conv windows the runner's plan
carried by its row map (the state_rows counter) against the chunk rows
(more than one new token) of the steps that ran a plan, and the chunk rows
of the steps that ran the whole grid; a program without the counter
prints nothing."""

import os
import sys

from h100bench.layers import load_reader
from h100bench.program import of

GRID_FILL = load_reader(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "grid_fill.prefill")


def read(ctx):
    p = of(ctx)
    win = {s.index for s in ctx.window_steps}
    steps = [(sp.counters, ctx.steps[i]) for i, (sp, _) in
             (p.steps.items() if p else ()) if i in win and sp.counters
             and sp.counters["prefill_rows"] > 0]
    if steps and all("state_rows" in c for c, _ in steps):
        plan = [(c, s) for c, s in steps if c["state_rows"] > 0]
        chunk = [sum(1 for n, _ in s.rows if n > 1) for _, s in plan]
        whole = sum(sum(1 for n, _ in s.rows if n > 1) for c, s in steps
                    if c["state_rows"] == 0)
        print(f"[bench_h100] state_rows {sum(c['state_rows'] for c, _ in plan)}"
              f" of {sum(chunk)} chunk rows over {len(plan)} planned steps "
              f"(of {len(steps)} carrying prefill rows; {whole} chunk rows "
              f"in the others)", file=sys.stderr, flush=True)
    return GRID_FILL.read(ctx)
