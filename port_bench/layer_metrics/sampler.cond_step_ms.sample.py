"""Device milliseconds per guided (cond) sampler step: the ``cond`` stage of
``ScenePipeline.stage_ms()`` over the window, over its guided steps."""


def read(facts, run):
    ms = facts.get("stage_ms", {}).get("cond")
    if ms is None or not facts.get("cond_steps"):
        return None
    return ms / facts["cond_steps"]
