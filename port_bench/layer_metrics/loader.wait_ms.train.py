"""Host milliseconds per step that the trainer waited for its loader's
items (``StepRecord.loader_waits``), summed over the window's steps and
divided by their count."""


def read(facts, run):
    waits = facts.get("loader_waits")
    return 1e3 * sum(waits) / len(waits) if waits else None
