"""K1's share of its roofline in the traced training steps: the forward
bound of every kernel site at the step's batch over the device time of the
kernels named ``packed_attention_fwd*``."""

from port_bench.readers import attention_roofline_percent

PATTERNS = ("packed_attention_fwd",)


def read(facts, run):
    return attention_roofline_percent(facts, PATTERNS)
