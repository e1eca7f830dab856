"""Device-idle milliseconds under the trainer's forward and backward
stages (``trainer.forward``, ``trainer.backward``: the UNet's loss and its
gradient), per traced step."""

from port_bench import spans


def read(facts, run):
    return spans.per(spans.idle_s(facts.get("trace"), ["trainer.forward", "trainer.backward"]),
                     facts.get("traced", {}).get("steps"), 1e3)
