"""K3's device milliseconds per traced training step: the kernels named
``zbuffer_resolve``."""

from port_bench.readers import device_ms_per

PATTERNS = ("zbuffer_resolve",)


def read(facts, run):
    return device_ms_per(facts, PATTERNS, "steps")
