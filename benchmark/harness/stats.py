"""The arithmetic of rates and percentiles, copied from the port's
``profiling.LatencyStats`` (nearest rank: the sorted sample at
``int(p · n)``) so that the benchmark keeps it when the program changes."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank ``p`` quantile (0 < p < 1); a missing answer is
    ``inf`` and sorts last."""
    if not len(values):
        return math.nan
    s = sorted(values)
    return s[min(len(s) - 1, int(p * len(s)))]


def rate(count: int, seconds: float) -> float:
    """Work per second over the whole window."""
    return count / seconds


def due_latencies(due: Sequence[float], done: Sequence[float]
                  ) -> list[float]:
    """Each request's latency from when it was due to when its answer came;
    a request that never got one (``nan`` done time) is ``inf``."""
    return [math.inf if (b != b) else b - a for a, b in zip(due, done)]
