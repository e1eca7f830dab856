"""Synchronising CUDA runtime calls (``port_bench.spans.SYNCS``) that
start under the trainer's steps (``trainer.step``), per traced step."""

from port_bench import spans


def read(facts, run):
    return spans.per(spans.syncs(facts.get("trace"), ["trainer.step"]),
                     facts.get("traced", {}).get("steps"))
