"""Timing of calls on the card.

Two numbers per call, over the same kind of warmed-up run of back-to-back
calls:

- :func:`device_ms`: device time. ``torch.profiler`` records every kernel,
  memset and copy that the calls put on the device; their durations are
  summed and divided by the number of calls. It does not see the host, so a
  call whose issue takes longer than its kernels is not timed as the issue.
  When the profiler records nothing, :func:`queued_ms` takes the reading.
- :func:`host_ms`: CUDA events recorded before and after the run. When the
  host issues calls more slowly than the device runs them, this measures the
  host; the gap to :func:`device_ms` is the host overhead.

:func:`call_ms` gives the benches' pair (or a host time on the CPU), and
:func:`card_line` the card's name and power limit to print beside them.
"""

from __future__ import annotations

import subprocess
import time
import warnings

import torch

# Cycles per second assumed for the spin kernel of :func:`queued_ms`: at least
# the SM clock of any card it runs on (H100: at most 1.98 GHz), so a spin of
# ``s * SPIN_HZ`` cycles lasts at least ``s`` seconds.
SPIN_HZ = 2.0e9

# How many :func:`device_ms` readings :func:`queued_ms` took because no
# profiler session recorded the calls' device activity.
fallbacks = 0


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call between CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call by CUDA events around ``reps`` calls that
    the host queued behind a spin kernel. The device runs them back to back
    once the spin ends, so the events see device time (with the gaps between
    kernels), not the host's issue time. The spin lasts twice the run's
    events time plus 2 ms; if the start event has passed before the last call
    is queued, the spin is made 4x longer and the run taken again (twice at
    most), else this raises. ``fn`` must not wait for the device."""
    spin_s = 2e-3 + 2 * reps * host_ms(fn, reps, warmup) * 1e-3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(spin_s * SPIN_HZ))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        spin_s *= 4
    raise RuntimeError("the calls could not be queued within the spin kernel")


def _device_events(prof):
    """The device activities (kernels, memsets, copies) of a finished
    ``torch.profiler`` session; annotated ranges are left out."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _device_us(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if us is None else us


def device_rows(prof, calls: int):
    """``(ms, launches, name)`` per call of each device activity (kernels,
    memsets, copies) in a finished ``torch.profiler`` session over ``calls``
    calls, largest first."""
    rows = [(_device_us(e) / 1e3 / calls, e.count // calls, e.key) for e in _device_events(prof)]
    rows.sort(reverse=True)
    return rows


def device_ms(fn, reps: int = 20, warmup: int = 3, match: str | None = None) -> float:
    """Device milliseconds per call: the summed durations of everything the
    ``reps`` calls ran on the device (only the activities whose name holds
    ``match``, if given), over ``reps``.

    A session counts only if it recorded some activity and each activity a
    whole number of times per call; the profiler has come back without the
    calls' activity on the H100 machine, in runs whose other sessions
    recorded theirs. After two sessions that do not count, the reading is
    :func:`queued_ms`'s (which times everything ``fn`` runs, whatever
    ``match``) and :data:`fallbacks` grows by one."""
    global fallbacks
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in _device_events(prof) if match is None or match in e.key]
        if events and all(e.count % reps == 0 for e in events):
            return sum(_device_us(e) for e in events) / 1e3 / reps
        seen = ", ".join(f"{e.key[:60]} x{e.count}" for e in events) or "no device activity"
        warnings.warn(f"torch.profiler session over {reps} calls (match {match!r}) "
                      f"does not count: {seen}", stacklevel=2)
    fallbacks += 1
    return queued_ms(fn, reps, warmup=0)


def call_ms(fn, device: torch.device) -> dict:
    """The times of one call of ``fn`` as the port's benches report them. On a
    CUDA device ``{"ms": device_ms, "host_ms": host_ms}``. On the CPU
    ``{"cpu_ms": ...}``, the host clock's mean over 3 calls after one, which
    times PyTorch's CPU kernels and is no device time."""
    if device.type == "cuda":
        return {"ms": device_ms(fn), "host_ms": host_ms(fn)}
    fn()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    return {"cpu_ms": (time.perf_counter() - t0) / 3 * 1e3}


def card_line() -> str:
    """The current card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[torch.cuda.current_device()]
