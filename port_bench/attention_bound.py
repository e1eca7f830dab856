"""The least time of packed attention on the card, for the K1/K4 rooflines.

A frozen copy of the arithmetic of ``ivid_tpu_torch/bench_attention.py:
bound_ms``: the products' operations (forward 4·B·H·T²·D, backward
10·B·H·T²·D) or the operand bytes (qkv and out; backward also dout, lse and
dqkv) at the memory rate, whichever takes longer. bf16 runs at the bf16
tensor-core peak; f32 as three TF32 tensor-core products per f32-accurate
product (split-TF32), the least the card can take for an f32 result.
"""

from __future__ import annotations

HEAD_DIM = 64
MIN_TOKENS = 512  # the port runs its kernel where T >= 512 and heads are 64 wide


def bound_s(b: int, t: int, heads: int, dtype: str, peaks: dict, backward: bool = False):
    """``(seconds, "operations" | "bytes")`` for one call at [b, t,
    3·heads·64] in ``dtype`` ("bf16" or "f32")."""
    d = HEAD_DIM
    size = 2 if dtype == "bf16" else 4
    flops = (10 if backward else 4) * b * heads * t * t * d
    nbytes = (b * t * 3 * heads * d + b * t * heads * d) * size
    if backward:
        nbytes += (b * t * heads * d + b * t * 3 * heads * d) * size + b * heads * t * 4
    t_ops = flops / peaks["bf16_flops"] if dtype == "bf16" else 3 * flops / peaks["tf32_flops"]
    t_bytes = nbytes / peaks["bytes"]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_sites(backbone_args: dict):
    """``[(tokens, heads)]`` of the UNet's attention sites that the port runs
    through its packed kernel (T >= 512, 64-wide heads), one entry a site."""
    s = backbone_args["image_size"]
    mc = backbone_args["model_channels"]
    mult = backbone_args["channel_mult"]
    res = backbone_args["attention_resolutions"]
    hc = backbone_args.get("num_head_channels") or HEAD_DIM
    nrb = backbone_args["num_res_blocks"]
    sites = []
    ds = s
    for level, m in enumerate(mult):
        ch = int(m * mc)
        if ds in res:
            # num_res_blocks sites on the way down, one more on the way up.
            sites += [(ds * ds, ch // hc)] * (2 * nrb + 1)
        if level != len(mult) - 1:
            ds //= 2
    if ds in res:
        sites.append((ds * ds, int(mult[-1] * mc) // hc))  # the middle block
    return [(t, h) for t, h in sites if t >= MIN_TOKENS and hc == HEAD_DIM]
