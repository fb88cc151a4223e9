"""Small shared utilities (port of the parts of ``repro.common.utils``
that the serving engine uses)."""
from __future__ import annotations

import math


def nearest_rank(sorted_xs, q: float) -> float:
    """q-th percentile (0..100) of an already-sorted sample, nearest-rank
    (index ``ceil(q/100 * n) - 1``, so q=50 over [a, b] reports ``a``):
    the one quantile definition of the engine's hedge deadlines
    (``LatencyTracker``) and of its latency reports."""
    n = len(sorted_xs)
    return sorted_xs[max(0, min(n - 1, math.ceil(q / 100.0 * n) - 1))]
