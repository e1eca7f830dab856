"""The program's spans in a :class:`port_bench.trace.Trace`, and the device's
idle time and the host's synchronising calls put down to them.

The program marks its layers with ``record_function`` spans while a
profiler runs (``ivid_tpu_torch/utils/profiling.py:span``); they land in
``Trace.host`` on the device's clock. A program span is a host event whose
name starts with one of :data:`PREFIXES`. The device is idle where the
traced window holds no device activity (the complement of the union that
``Trace.busy_s`` sums), and an idle instant belongs to a span when the span
covers it, whatever the thread; a layer's self idle is the idle under its
spans that none of its child spans covers. Every set is a union of
intervals, sorted and merged once, so a whole trace is read in O(n log n)
with no limit on how far back a span may start.

Each function returns None when the trace holds none of the spans it reads
(a program that marks no spans, as before they existed).
"""

from __future__ import annotations

import bisect
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PREFIXES = ("pipeline.", "sampler.", "unet.", "attention.", "raster_dense.",
            "raster_tiled.", "trainer.", "warp_cond.")
#: CUDA runtime calls after which the host has waited for the device.
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})

Intervals = List[Tuple[float, float]]

_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def merge(intervals: Iterable[Tuple[float, float]]) -> Intervals:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: Intervals = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def intersect(a: Intervals, b: Intervals) -> Intervals:
    """``a ∩ b`` of two merged lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: Intervals, b: Intervals) -> Intervals:
    """``a \\ b`` of two merged lists."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def total(a: Intervals) -> float:
    return sum(e - s for s, e in a)


class _Read:
    """What one trace gives every reader: the idle intervals, the program's
    spans merged by name, and the start of each synchronising call."""

    def __init__(self, tr):
        lo, hi = tr.window
        self.window_s = tr.window_s
        self.idle = subtract([(lo, hi)], [tuple(x) for x in tr._busy_intervals()])
        by_name: Dict[str, list] = {}
        syncs = []
        for name, s, e in tr.host:
            if name.startswith(PREFIXES):
                by_name.setdefault(name, []).append((s, e))
            elif name in SYNCS:
                syncs.append(s)
        self.spans = {k: merge(v) for k, v in by_name.items()}
        self.all = merge(iv for v in self.spans.values() for iv in v)
        self.syncs = sorted(syncs)

    def union(self, names: Sequence[str]) -> Optional[Intervals]:
        found = [self.spans[n] for n in names if n in self.spans]
        if not found:
            return None
        return found[0] if len(found) == 1 else merge(iv for v in found for iv in v)


def _read(tr) -> Optional[_Read]:
    if tr is None:
        return None
    if tr not in _cache:
        _cache[tr] = _Read(tr)
    return _cache[tr]


def idle_s(tr, names: Sequence[str], minus: Sequence[str] = ()) -> Optional[float]:
    """Device-idle seconds under the spans named ``names`` and under none
    named ``minus`` (a layer's self idle when ``minus`` names its child
    spans); None when the trace holds no span named ``names``."""
    r = _read(tr)
    under = r.union(names) if r is not None else None
    if under is None:
        return None
    idle = intersect(r.idle, under)
    children = r.union(minus) if minus else None
    return total(subtract(idle, children) if children else idle)


def syncs(tr, names: Sequence[str]) -> Optional[int]:
    """Synchronising runtime calls (:data:`SYNCS`) that start under the
    spans named ``names``; None when the trace holds none of those spans."""
    r = _read(tr)
    under = r.union(names) if r is not None else None
    if under is None:
        return None
    starts = [s for s, _ in under]
    n = 0
    for t in r.syncs:
        i = bisect.bisect_right(starts, t) - 1
        n += i >= 0 and t < under[i][1]
    return n


def unattributed_idle_percent(tr) -> Optional[float]:
    """The device's idle time under no program span, over the traced
    window, in percent; None when the trace holds no program span."""
    r = _read(tr)
    if r is None or not r.all or r.window_s <= 0:
        return None
    return 100.0 * total(subtract(r.idle, r.all)) / r.window_s


def per(value, n, scale: float = 1.0):
    """``scale * value / n``; None when ``value`` is None or ``n`` is 0."""
    if value is None or not n:
        return None
    return scale * value / n


def sampler_steps(facts) -> int:
    """The traced sampler steps: the summed count of the traced forwards
    (one forward of each model a step)."""
    return sum(f["count"] for f in facts.get("traced", {}).get("forwards", []))
