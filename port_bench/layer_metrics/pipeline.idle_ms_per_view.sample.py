"""Device-idle milliseconds under the pipeline's batches
(``pipeline.sample_batch``) but not under the sampler's steps
(``sampler.step``): the mesh lifts, the aggregation, the stacking and the
glue between the stages, per traced novel view."""

from port_bench import spans


def read(facts, run):
    return spans.per(spans.idle_s(facts.get("trace"), ["pipeline.sample_batch"],
                                  ["sampler.step"]),
                     facts.get("traced", {}).get("novel_views"), 1e3)
