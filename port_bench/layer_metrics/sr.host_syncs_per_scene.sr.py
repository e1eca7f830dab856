"""Synchronising CUDA runtime calls (``port_bench.spans.SYNCS``) that start
under the SR entry's scenes (``sr.scene``), per traced scene: the host's
waits for the device inside ``upsample_views``."""

from port_bench import spans, sr_spans


def read(facts, run):
    return spans.per(sr_spans.syncs(facts.get("trace"), "sr.scene"),
                     facts.get("traced", {}).get("scenes"))
