"""Percentiles and spreads as the benchmark reports them."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q`` % of the values at or below it. Values may be ``inf`` (a
    request that was refused or failed), which sort last."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("no values")
    return v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)]


def spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, with the quartiles of
    ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
