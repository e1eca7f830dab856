"""Device milliseconds per uncond sampler step: the ``uncond`` stage of
``ScenePipeline.stage_ms()`` over the window, over its uncond steps."""


def read(facts, run):
    ms = facts.get("stage_ms", {}).get("uncond")
    if ms is None or not facts.get("uncond_steps"):
        return None
    return ms / facts["uncond_steps"]
