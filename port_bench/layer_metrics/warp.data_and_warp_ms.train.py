"""Device milliseconds per step of the trainer's ``data_and_warp`` stage
(``StepRecord``: the batch to the device and the warp conditioning), summed
over the window's steps and divided by their count."""


def read(facts, run):
    rows = facts.get("stage_ms")
    return sum(r["data_and_warp"] for r in rows) / len(rows) if rows else None
