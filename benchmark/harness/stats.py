"""Small statistics of the benchmark: the rate over whole images and a
percentile."""
from __future__ import annotations

import statistics
from typing import Optional, Sequence


def rate_per_min(done: int, window_s: float) -> Optional[float]:
    """Images completed over the window (first start to last counted end)."""
    if done <= 0 or window_s <= 0:
        return None
    return 60.0 * done / window_s


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0 < q < 100), linear between order statistics
    (``statistics.quantiles`` with the inclusive method)."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[int(q) - 1]

