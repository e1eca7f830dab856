"""Device milliseconds per step of the trainer's ``forward`` and
``backward`` stages (``StepRecord``), summed over the window's steps and
divided by their count."""


def read(facts, run):
    rows = facts.get("stage_ms")
    return sum(r["forward"] + r["backward"] for r in rows) / len(rows) if rows else None
