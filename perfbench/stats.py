"""The benchmark's statistics: percentiles and the spread of repeated runs."""

from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between the closest ranks (numpy's default); None for no
    values. An infinite value sorts last and is returned as it is."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == xs[lo]:
        return float(xs[lo])
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def spread(values: Sequence[float]) -> Optional[float]:
    """The distance between the first and the third quartile as a share of
    the median (``statistics.quantiles(values, n=4)``); None for fewer than
    two values or a median of 0."""
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return None if med == 0 else abs(q3 - q1) / abs(med)
