"""engine/batched.py: mean ms a window step spends in batched.sample (every
row's sampler call and logprobs), the profiled slice left out."""

from h100bench.program import phase_ms


def read(ctx):
    return phase_ms(ctx, "batched.sample")
