"""The rules of the measured window, kept apart so tests can drive them on a
fake clock."""

from __future__ import annotations

import statistics
import time
from typing import Callable, List


def run_whole_batches(call: Callable[[int], None], seconds: float,
                      clock: Callable[[], float] = time.perf_counter) -> List[float]:
    """Call ``call(i)`` for i = 0, 1, … while the time so far plus the last
    finished call's time still fits in ``seconds``; the first call always
    runs. Returns each call's seconds; their sum is the window."""
    times: List[float] = []
    elapsed = 0.0
    while not times or elapsed + times[-1] <= seconds:
        t0 = clock()
        call(len(times))
        times.append(clock() - t0)
        elapsed += times[-1]
    return times


def p90(values) -> float:
    """The 90th percentile of ``values`` (``statistics.quantiles``, n=10,
    the exclusive method)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=10)[-1])
