"""Device-idle milliseconds under the sampler's steps (``sampler.step``)
but not under the UNet's forwards inside them (``unet.forward``): the
step's own update and noise draw, per traced sampler step."""

from port_bench import spans


def read(facts, run):
    return spans.per(spans.idle_s(facts.get("trace"), ["sampler.step"], ["unet.forward"]),
                     spans.sampler_steps(facts), 1e3)
