"""Device-idle milliseconds under the SR entry's scenes (the spans
``sr.scene``) but not under the sampler's steps (``sampler.step``): the
chunks' condition and noise, the concatenation and the glue between the
steps, per traced scene."""

from port_bench import spans, sr_spans


def read(facts, run):
    return spans.per(sr_spans.idle_s(facts.get("trace"), "sr.scene", ["sampler.step"]),
                     facts.get("traced", {}).get("scenes"), 1e3)
