"""Device-idle milliseconds under the UNet's forwards (the spans
``unet.forward``) in the traced batches, per traced sampler step."""

from port_bench import spans


def read(facts, run):
    return spans.per(spans.idle_s(facts.get("trace"), ["unet.forward"]),
                     spans.sampler_steps(facts), 1e3)
