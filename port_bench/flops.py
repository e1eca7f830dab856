"""Operations of one UNet forward, counted over the reference UNet.

``torch.utils.flop_counter`` counts the matrix products and convolutions
(2 per multiply-add) of the reference UNet (:mod:`port_bench.reference.unet`)
run on the meta device: shapes only, no arithmetic. Attention counts as its
two products at every site, whatever kernel the program runs there.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference.unet import build_unet


@functools.lru_cache(maxsize=None)
def _forward_flops(args_key: tuple, batch: int) -> int:
    args = dict(args_key)
    with torch.device("meta"):
        model = build_unet(args)
        s = args["image_size"]
        x = torch.empty((batch, s, s, args["in_channels"]))
        t = torch.zeros((batch,), dtype=torch.long)
        classes = (torch.zeros((batch,), dtype=torch.long)
                   if args.get("num_classes") else None)
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            model(x, t, classes)
    return int(counter.get_total_flops())


def forward_flops(backbone_args: dict, batch: int) -> int:
    """FLOPs of one forward of the UNet of ``backbone_args`` at ``batch``."""
    key = tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                       for k, v in backbone_args.items()))
    return _forward_flops(key, int(batch))


def peak_key(backbone_args: dict) -> str:
    """Which peak bounds the model's products on the card: the bf16 tensor
    cores for a ``use_fp16`` model, TF32 for a float32 one (cuDNN runs its
    convolutions in TF32 by default, and they are nearly all its FLOPs)."""
    return "bf16_flops" if backbone_args.get("use_fp16") else "tf32_flops"
