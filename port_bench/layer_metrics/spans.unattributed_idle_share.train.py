"""The device's idle time under no program span (the harness's own host
work between steps, or a layer that marks none), over the traced window,
in percent."""

from port_bench import spans


def read(facts, run):
    return spans.unattributed_idle_percent(facts.get("trace"))
