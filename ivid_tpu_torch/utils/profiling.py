"""Profiling: named spans on the profiler's timeline, and a torch.profiler
trace around a region, the port's counterpart of
``ivid_tpu/utils/profiling.py``'s ``trace`` (``train.py --profile_dir``,
``sample.py --profile_dir``). The trainer's ``StepRecord`` takes the place
of its ``StepTimer``."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

_NO_SPAN = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager marking its body as ``name`` on the profiler's
    timeline (a ``record_function``, on the same clock as the device's
    activity) while a torch.profiler session records this thread; otherwise
    a shared no-op, after one check of the profiler's state. Threads that
    launch device work carry the session: the one that started it, and the
    autograd engine's in a backward it runs."""
    if not _profiling():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool = False, rank: int = 0) -> Iterator[None]:
    """Profile the enclosed region with torch.profiler (CPU activity, and
    the CUDA device's with ``cuda``), then write a Chrome trace,
    ``{log_dir}/trace_rank{rank}_{time}.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    stamp = time.strftime("%Y%m%d-%H%M%S")
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_rank{rank}_{stamp}.json"))
