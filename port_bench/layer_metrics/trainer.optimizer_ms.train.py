"""Device milliseconds per step of the trainer's ``optimizer`` stage
(``StepRecord``: AdamW and the EMA update), over the window's steps."""


def read(facts, run):
    rows = facts.get("stage_ms")
    return sum(r["optimizer"] for r in rows) / len(rows) if rows else None
