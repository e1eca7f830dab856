"""Launches of the UNet's residual-sum kernel (device symbols named
``bias_residual_``) in the traced batches, per traced forward
(``spans.sampler_steps``): 35.0 where every residual block of every forward
leaves its convolutions' biases to the kernels. None where the trace holds
no such kernel (a program without it)."""

from port_bench import spans

PATTERNS = ("bias_residual_",)


def read(facts, run):
    tr = facts.get("trace")
    if tr is None:
        return None
    n = tr.count(PATTERNS)
    return spans.per(n, spans.sampler_steps(facts)) if n else None
