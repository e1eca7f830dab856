"""Device milliseconds of the aggregation stage per novel view: the
``aggregation`` stage of ``ScenePipeline.stage_ms()`` (CUDA events around
``warp.aggregate_conditions_batch``) over the window, over the novel views
the window finished."""


def read(facts, run):
    ms = facts.get("stage_ms", {}).get("aggregation")
    if ms is None or not facts.get("novel_views"):
        return None
    return ms / facts["novel_views"]
