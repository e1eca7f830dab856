"""The device's idle share of the traced window: the window minus the union
of its device activity, over the window, in percent."""

from port_bench.readers import idle_percent


def read(facts, run):
    return idle_percent(facts)
