"""Device idle and synchronising calls under the program's spans of one
name, whatever its prefix: :mod:`port_bench.spans` reads only the spans
whose names start with its ``PREFIXES``, which the SR entry's ``sr.*`` spans
postdate. The same interval arithmetic over the whole trace.
"""

from __future__ import annotations

import bisect
from typing import Optional, Sequence

from port_bench import spans


def intervals(tr, names: Sequence[str]) -> spans.Intervals:
    """The union of the host events named ``names``."""
    names = set(names)
    return spans.merge((s, e) for n, s, e in tr.host if n in names)


def idle_s(tr, name: str, minus: Sequence[str] = ()) -> Optional[float]:
    """Device-idle seconds of the traced window under the spans ``name`` and
    under none of ``minus``; None without a trace or such a span."""
    under = intervals(tr, [name]) if tr is not None else []
    if not under:
        return None
    idle = spans.subtract([tr.window], spans.merge((s, e) for _, s, e in tr.device))
    idle = spans.intersect(idle, under)
    if minus:
        idle = spans.subtract(idle, intervals(tr, minus))
    return spans.total(idle)


def syncs(tr, name: str) -> Optional[int]:
    """Synchronising runtime calls (``spans.SYNCS``) that start under the
    spans ``name``; None without a trace or such a span."""
    under = intervals(tr, [name]) if tr is not None else []
    if not under:
        return None
    starts = [s for s, _ in under]
    n = 0
    for call, s, _ in tr.host:
        if call in spans.SYNCS:
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and s < under[i][1]
    return n
