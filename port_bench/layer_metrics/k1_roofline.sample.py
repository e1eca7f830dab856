"""K1's share of its roofline in the traced batches: the packed-attention
bound (``port_bench.attention_bound``) of every site the port runs through
K1 (T >= 512, 64-wide heads), at each traced forward's batch and type, over
the device time of the kernels named ``packed_attention_fwd*``."""

from port_bench.readers import attention_roofline_percent

PATTERNS = ("packed_attention_fwd",)


def read(facts, run):
    return attention_roofline_percent(facts, PATTERNS)
