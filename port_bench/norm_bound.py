"""The least bytes the UNet's GroupNorm sites move, for the norm roofline.

Every ``GroupNorm32`` call of the reference UNet (:mod:`port_bench.reference.
unet`), run on the meta device at a batch (shapes only, as
:mod:`port_bench.flops` walks it), reads its input once and writes its
output once, both in the torso's type (bf16 for a ``use_fp16`` model, else
f32): the least any implementation of the 87 sites moves, whatever it fuses
around them.
"""

from __future__ import annotations

import functools

import torch

from port_bench.reference.unet import GroupNorm32, build_unet


@functools.lru_cache(maxsize=None)
def _site_elements(args_key: tuple, batch: int) -> tuple:
    args = dict(args_key)
    sizes = []
    with torch.device("meta"):
        model = build_unet(args)
        for m in model.modules():
            if isinstance(m, GroupNorm32):
                m.register_forward_hook(lambda mod, inp, out: sizes.append(inp[0].numel()))
        s = args["image_size"]
        x = torch.empty((batch, s, s, args["in_channels"]))
        t = torch.zeros((batch,), dtype=torch.long)
        classes = (torch.zeros((batch,), dtype=torch.long)
                   if args.get("num_classes") else None)
        with torch.no_grad():
            model(x, t, classes)
    return tuple(sizes)


def site_elements(backbone_args: dict, batch: int) -> tuple:
    """Elements of each GroupNorm site's input in one forward of the UNet of
    ``backbone_args`` at ``batch``, in call order."""
    key = tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                       for k, v in backbone_args.items()))
    return _site_elements(key, int(batch))


def bound_s(backbone_args: dict, batch: int, peaks: dict) -> float:
    """Seconds of one forward's GroupNorm sites at the card's memory rate:
    each input read once and each output written once in the torso's type."""
    size = 2 if backbone_args.get("use_fp16") else 4
    return 2 * size * sum(site_elements(backbone_args, batch)) / peaks["bytes"]
