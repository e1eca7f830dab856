"""The 90th percentile over every step of the window of the step's time:
the interval between the CUDA events recorded after consecutive
``run_step`` calls (no synchronisation per step)."""

from port_bench.window import p90


def read(facts, run):
    steps = facts.get("step_ms")
    return p90(steps) if steps else None
