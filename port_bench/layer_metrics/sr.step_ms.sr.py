"""Device milliseconds per guided step of the SR sampler: CUDA events
recorded around each scene's ``upsample_views`` call over the window, over
its guided steps (one forward of every chunk a step)."""


def read(facts, run):
    ms = facts.get("sr_ms")
    if not ms or not facts.get("guided_steps"):
        return None
    return sum(ms) / facts["guided_steps"]
