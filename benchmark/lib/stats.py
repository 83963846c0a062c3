"""Percentile arithmetic: a frozen copy of the rule
``evreal_tpu_torch/bench/timing.py`` takes from numpy, linear
interpolation between the closest ranks."""

import math


def percentile(values, q):
    """The ``q``-th percentile of ``values`` (numpy's default, linear
    rule): rank ``q / 100 * (n - 1)`` between its two neighbours."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = q / 100.0 * (len(xs) - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)
