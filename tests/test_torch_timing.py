"""The port's device-time measurement (``ivid_tpu_torch.timing``) on the CPU,
with torch.profiler and CUDA events replaced by fakes: the per-call sums, the
name filter, one more session when a session records no device activity or
not a whole number of launches per call, the fallback to calls queued behind
a spin kernel (after as many sessions as asked), and that fallback's own
check of the queueing."""

import pytest
import torch

from ivid_tpu_torch import timing


class _Event:
    def __init__(self, key, device_us, count, device_type=torch.autograd.DeviceType.CUDA):
        self.key, self.self_device_time_total, self.count = key, device_us, count
        self.device_type = device_type


def _fake_profiler(monkeypatch, sessions):
    """Each ``with torch.profiler.profile(...)`` yields the next list of events."""
    taken = []

    class Session:
        def __init__(self, **_):
            self.events = sessions[len(taken)]
            taken.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", Session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return taken


def test_device_ms_sums_device_activity_per_call(monkeypatch):
    calls = []
    events = [_Event("attn_fwd", 40.0, 20), _Event("memset", 10.0, 20),
              _Event("cpu op", 500.0, 20, torch.autograd.DeviceType.CPU)]
    _fake_profiler(monkeypatch, [events, events])
    assert timing.device_ms(lambda: calls.append(1), reps=20, warmup=3) == pytest.approx(0.0025)
    assert len(calls) == 23
    assert timing.device_ms(lambda: None, reps=20, match="attn") == pytest.approx(0.002)


def test_device_ms_takes_one_more_session_when_one_records_nothing(monkeypatch):
    taken = _fake_profiler(monkeypatch, [[], [_Event("k", 30.0, 10)]])
    with pytest.warns(UserWarning, match="no device activity"):
        assert timing.device_ms(lambda: None, reps=10) == pytest.approx(0.003)
    assert len(taken) == 2
    _fake_profiler(monkeypatch, [[], []])
    monkeypatch.setattr(timing, "queued_ms", lambda fn, reps, warmup: 0.5)
    before = timing.fallbacks
    with pytest.warns(UserWarning, match="no device activity"):
        assert timing.device_ms(lambda: None, reps=10) == 0.5
    assert timing.fallbacks == before + 1


def test_device_ms_takes_one_more_session_when_launches_are_not_whole_per_call(monkeypatch):
    taken = _fake_profiler(monkeypatch, [[_Event("k", 30.0, 19)], [_Event("k", 40.0, 20)]])
    with pytest.warns(UserWarning, match="k x19"):
        assert timing.device_ms(lambda: None, reps=20) == pytest.approx(0.002)
    assert len(taken) == 2


def test_device_ms_takes_as_many_sessions_as_asked(monkeypatch):
    bad = [_Event("k", 30.0, 3)]
    taken = _fake_profiler(monkeypatch, [bad] * 5 + [[_Event("k", 40.0, 4)]])
    with pytest.warns(UserWarning, match="k x3"):
        assert timing.device_ms(lambda: None, reps=2, sessions=6) == pytest.approx(0.02)
    assert len(taken) == 6


def _fake_events(monkeypatch, started):
    """CUDA events whose start has passed (``query``) as ``started`` says, one
    value per run, and which read 8 ms between start and end; the spin
    kernel's cycle counts are returned as they are asked for."""
    spins, runs = [], iter(started)

    class Event:
        def __init__(self, **_):
            pass

        def record(self):
            pass

        def query(self):
            return next(runs)

        def elapsed_time(self, end):
            return 8.0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", spins.append)
    monkeypatch.setattr(timing, "host_ms", lambda fn, reps, warmup: 0.1)
    return spins


def test_queued_ms_times_the_calls_queued_behind_the_spin(monkeypatch):
    spins = _fake_events(monkeypatch, [True, False])
    calls = []
    assert timing.queued_ms(lambda: calls.append(1), reps=20) == pytest.approx(0.4)
    # 2 ms + twice the run's 20 x 0.1 ms, then 4x longer after the first
    # spin ran out before the calls were queued.
    first = int((2e-3 + 2 * 20 * 0.1e-3) * timing.SPIN_HZ)
    assert spins == [first, int(4 * (2e-3 + 2 * 20 * 0.1e-3) * timing.SPIN_HZ)]
    assert len(calls) == 40


def test_queued_ms_raises_when_the_spin_never_covers_the_calls(monkeypatch):
    spins = _fake_events(monkeypatch, [True, True, True])
    with pytest.raises(timing.NotQueued, match="could not be queued"):
        timing.queued_ms(lambda: None, reps=10)
    assert len(spins) == 3 and spins[2] == pytest.approx(16 * spins[0], rel=1e-6)


def test_l2_cleared_writes_its_scratch_before_each_call():
    calls = []
    fn = timing.l2_cleared(lambda: calls.append(1) or len(calls), "cpu", nbytes=4096)
    assert fn.scratch.numel() == 4096 and not calls
    fn.scratch.zero_()
    assert fn() == 1 and bool((fn.scratch == 1).all()) and fn() == 2
