"""One torch.profiler session over part of the window, read into plain lists.

:func:`session` records host operations and device activity (kernels,
copies, memsets) over the calls made inside it, bracketed by the annotation
``port_bench.window``. :class:`Trace` keeps the device intervals and the host
operations in seconds, and answers what the per-layer readers ask: a kernel
family's device time by name pattern, the device's busy time (the union of
its activity) within the traced window, the largest device operations, and
the idle gaps labelled by the host operation running in them. The way of
reading device time is that of ``ivid_tpu_torch/timing.py``: the durations
of everything the profiler records on the device.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import List, Optional, Tuple

import torch

WINDOW = "port_bench.window"


class Trace:
    def __init__(self, device: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]], window: Tuple[float, float]):
        #: (name, start s, end s) of each device activity, by start.
        self.device = sorted(device, key=lambda e: e[1])
        #: (name, start s, end s) of each host operation.
        self.host = host
        self.window = window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def device_s(self, patterns) -> float:
        """Summed device seconds of the activities whose name holds any of
        ``patterns``."""
        return sum(e - s for n, s, e in self.device if any(p in n for p in patterns))

    def count(self, patterns) -> int:
        return sum(1 for n, _, _ in self.device if any(p in n for p in patterns))

    def _busy_intervals(self):
        lo, hi = self.window
        merged = []
        for _, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy_intervals())

    def top_device_ops(self, n: int = 10):
        by_name: dict = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        return sorted(([k[:200], v] for k, v in by_name.items()), key=lambda r: -r[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The device's idle time within the window summed by what the host
        was doing: the innermost host operation that covers each gap's
        middle (``idle`` where none does), largest first."""
        lo, hi = self.window
        busy = self._busy_intervals()
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        ops = sorted((s, e, name) for name, s, e in self.host if name != WINDOW)
        starts = [o[0] for o in ops]
        totals: dict = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            best = None
            # Host operations are short; look back over those started before
            # the middle for the innermost one that covers it.
            i = bisect.bisect_right(starts, mid)
            for k in range(i - 1, max(-1, i - 2000), -1):
                os_, oe, name = ops[k]
                if oe >= mid and (best is None or oe - os_ < best[1] - best[0]):
                    best = (os_, oe, name)
            label = best[2][:200] if best else "idle"
            totals[label] = totals.get(label, 0.0) + (e - s)
        return sorted(([k, v] for k, v in totals.items()), key=lambda r: -r[1])[:n]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_device_ops(), "idle_gaps": self.idle_gaps()}


def read(prof) -> Optional[Trace]:
    """The :class:`Trace` of a finished session (None when the profiler
    recorded no window)."""
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), s, t))
        else:
            host.append((e.name(), s, t))
            if e.name() == WINDOW:
                window = (s, t)
    if window is None:
        return None
    return Trace(device, host, window)


@contextlib.contextmanager
def session(box: list):
    """Profile the body, the device synchronised at its end; appends the
    finished profiler to ``box``. Reading it (:func:`read`) takes long for a
    long session, so callers read it once their window has closed."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    box.append(prof)
