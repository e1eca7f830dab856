"""K2's device milliseconds per novel view in the traced batches: the
kernels named ``k2_*`` (bins and raster)."""

from port_bench.readers import device_ms_per

PATTERNS = ("k2_",)


def read(facts, run):
    return device_ms_per(facts, PATTERNS, "novel_views")
