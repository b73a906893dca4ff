"""The end-to-end metrics, from the requests' host-clock stamps.

A rate is taken over all the work and all the time of the window; a tail
over all requests or gaps, failures at +inf. A tail that lands on a
failure reads FAILED_MS.
"""

from __future__ import annotations

import math

FAILED_MS = 1e9  # a 95th percentile that lands on a failed request


def quantile(values: list[float], q: float) -> float:
    """The q-quantile with linear interpolation between order statistics
    (numpy's default); +inf sorts last, and an interpolation that touches
    it is +inf."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = q * (len(xs) - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def due_in_window(recs, t0: float, t1: float) -> list:
    return [r for r in recs if t0 <= r.due < t1]


def output_tps(recs, t0: float, t1: float) -> float:
    """Completion tokens emitted in [t0, t1] over its seconds."""
    n = sum(1 for r in recs for t in r.times if t0 <= t <= t1)
    return n / (t1 - t0)


def ttft_ms(rec) -> float:
    """Due (or submitted) to first token; +inf if refused or none came."""
    if rec.refused or not rec.times:
        return math.inf
    return (rec.times[0] - rec.due) * 1e3


def ttft_p95_ms(recs, t0: float, t1: float) -> float:
    v = quantile([ttft_ms(r) for r in due_in_window(recs, t0, t1)], 0.95)
    return FAILED_MS if math.isinf(v) else v


def itl_p95_ms(recs, t0: float, t1: float) -> float:
    """p95 of every gap between consecutive tokens of a request that ends
    inside the window."""
    gaps = [(b - a) * 1e3 for r in recs for a, b in zip(r.times, r.times[1:])
            if t0 <= b <= t1]
    return quantile(gaps, 0.95)


def failed(recs, t0: float, t1: float) -> int:
    """Requests due in the window that were refused or had no first token
    by the end of the drain."""
    return sum(1 for r in due_in_window(recs, t0, t1)
               if math.isinf(ttft_ms(r)))
