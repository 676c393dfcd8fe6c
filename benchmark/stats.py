"""Statistics of a run, taken over all of its work."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile of every value, linear between the two nearest
    ranks (numpy's default); a missing value (a failed request, +inf)
    ranks above all others, so a tail with failures in it is infinite."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds
