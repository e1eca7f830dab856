"""Synchronising CUDA runtime calls (``port_bench.spans.SYNCS``) that
start under the pipeline's batches (``pipeline.sample_batch``), per traced
batch: the host's waits for the device inside ``sample_batch``."""

from port_bench import spans


def read(facts, run):
    return spans.per(spans.syncs(facts.get("trace"), ["pipeline.sample_batch"]),
                     facts.get("traced", {}).get("batches"))
