"""Model FLOP utilisation of the training window: three times the forward
FLOPs at the step's batch (forward and backward), counted over the reference
UNet, at the model's peak, as seconds at peak over the window's seconds."""

from port_bench.readers import mfu_percent


def read(facts, run):
    return mfu_percent(facts)
