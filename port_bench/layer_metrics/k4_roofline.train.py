"""K4's share of its roofline in the traced training steps: the backward
bound of every kernel site at the step's batch over the device time of the
kernels named ``attn_bwd*`` (the statistics kernel and the backward)."""

from port_bench.readers import attention_roofline_percent

PATTERNS = ("attn_bwd",)


def read(facts, run):
    return attention_roofline_percent(facts, PATTERNS, backward=True)
