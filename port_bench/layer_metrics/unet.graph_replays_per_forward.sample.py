"""Replays of the UNet's CUDA graphs (the spans ``unet.graph_replay``) in
the traced batches, per traced forward (``spans.sampler_steps``): 1.0 where
every forward replays a graph. None where the trace holds no such span (a
program without the graphed forward)."""

from port_bench import spans

SPAN = "unet.graph_replay"


def read(facts, run):
    tr = facts.get("trace")
    if tr is None:
        return None
    n = sum(1 for name, _, _ in tr.host if name == SPAN)
    return spans.per(n, spans.sampler_steps(facts)) if n else None
