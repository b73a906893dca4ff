"""engine/batched.py: the scheduler thread's wall time per step outside
runner.step (admission, the step's arrays, host sampling and emission),
summed over the window's steps and divided by their count."""

from h100bench.layers import mean_ms


def read(ctx):
    return mean_ms([s.host_s for s in ctx.window_steps
                    if s.host_s is not None])
