"""The window's rules on a fake clock."""

from __future__ import annotations

import statistics

from port_bench.window import p90, run_whole_batches


class FakeClock:
    def __init__(self, durations):
        self.t = 0.0
        self.durations = list(durations)
        self.calls = 0

    def now(self):
        return self.t

    def work(self, i):
        self.t += self.durations[i]
        self.calls += 1


def test_whole_batches_stop_before_the_limit():
    """A batch starts only while the time so far plus the last batch's time
    fits: with 9 s batches and 45 s, the fifth starts at 36 s (36 + 9 = 45)
    and a sixth would not."""
    clock = FakeClock([9.0] * 10)
    times = run_whole_batches(clock.work, 45.0, clock=clock.now)
    assert times == [9.0] * 5 and clock.calls == 5


def test_a_slow_batch_ends_the_window_early():
    clock = FakeClock([2.0, 2.0, 30.0, 2.0, 2.0])
    times = run_whole_batches(clock.work, 40.0, clock=clock.now)
    assert times == [2.0, 2.0, 30.0]


def test_the_first_batch_always_runs():
    clock = FakeClock([100.0])
    assert run_whole_batches(clock.work, 10.0, clock=clock.now) == [100.0]


def test_p90_over_all_steps():
    values = [float(v) for v in range(1, 251)]
    assert p90(values) == statistics.quantiles(values, n=10)[-1]
    assert 225.0 <= p90(values) <= 226.0
    assert p90([7.0]) == 7.0
