"""Model FLOP utilisation of the sampling window: every UNet forward the
window ran (a guided step's forward counts at twice the batch), its FLOPs
counted over the reference UNet, each model's at its peak (bf16 989 TFLOP/s
for a ``use_fp16`` model, TF32 494.7 TFLOP/s for a float32 one), as seconds
at peak over the window's seconds."""

from port_bench.readers import mfu_percent


def read(facts, run):
    return mfu_percent(facts)
