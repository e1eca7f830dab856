"""Launches of the UNet's GroupNorm kernel (device symbols named ``gn_act_``)
in the traced batches, per traced forward (``spans.sampler_steps``): 87.0
where every GroupNorm site of every forward goes through it. None where
the trace holds no such kernel (a program without it)."""

from port_bench import spans

PATTERNS = ("gn_act_",)


def read(facts, run):
    tr = facts.get("trace")
    if tr is None:
        return None
    n = tr.count(PATTERNS)
    return spans.per(n, spans.sampler_steps(facts)) if n else None
