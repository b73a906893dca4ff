"""engine/batched.py: mean ms from submit to admission (the request.queued
span) of the requests submitted in the window, the profiled slice left
out."""

from h100bench.program import queue_wait_ms


def read(ctx):
    return queue_wait_ms(ctx)
