"""Device-idle milliseconds under the trainer's conditioning stage
(``trainer.data_and_warp``: the warp synthesis), per traced step."""

from port_bench import spans


def read(facts, run):
    return spans.per(spans.idle_s(facts.get("trace"), ["trainer.data_and_warp"]),
                     facts.get("traced", {}).get("steps"), 1e3)
