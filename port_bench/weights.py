"""Seeded model weights, drawn on the device in one call per model.

The statistics of ``ivid_tpu_torch/models/adm.py:randomize_parameters``
(weights N(0, 1/fan_in), biases N(0, 0.02²), GroupNorm scales 1 + N(0, 0.1²)
and shifts N(0, 0.1²), class embeddings N(0, 1)), so that every layer
reaches the output: a fresh init's zero output convolution makes the model
predict exactly zero, which no comparison could tell from a fault. One
``torch.randn`` over all parameters of the model from a ``torch.Generator``
on the device, seeded from the run's seed and the model's role, is cut into
the parameters in name order and scaled in place. The same seed gives the
same weights to the program and to the reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from port_bench.noise import derive
from port_bench.reference.unet import build_unet


def layout(backbone_args: dict):
    """``[(name, shape, kind)]`` of the UNet's parameters in name order;
    ``kind`` is ``norm_scale``, ``norm_shift``, ``embedding``, ``weight`` or
    ``bias``, from the reference UNet's own modules."""
    with torch.device("meta"):
        model = build_unet(backbone_args)
    norms = {}
    for m in model.modules():
        if isinstance(m, nn.GroupNorm):
            norms[id(m.weight)] = "norm_scale"
            norms[id(m.bias)] = "norm_shift"
    out = []
    for name, p in sorted(model.named_parameters()):
        if id(p) in norms:
            kind = norms[id(p)]
        elif name.startswith("label_emb"):
            kind = "embedding"
        else:
            kind = "weight" if p.dim() >= 2 else "bias"
        out.append((name, tuple(p.shape), kind))
    return out


@torch.no_grad()
def draw(backbone_args: dict, seed: int, role: str, device) -> dict:
    """The float32 weights ``{name: tensor}`` of one model (views into one
    buffer on ``device``), from ``seed`` and the model's ``role``."""
    params = layout(backbone_args)
    total = sum(int(torch.Size(s).numel()) for _, s, _ in params)
    gen = torch.Generator(device=device).manual_seed(derive(0, "weights", int(seed), role))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, kind in params:
        n = int(torch.Size(shape).numel())
        v = flat[off:off + n].view(shape)
        off += n
        if kind == "norm_scale":
            v.mul_(0.1).add_(1.0)
        elif kind == "norm_shift":
            v.mul_(0.1)
        elif kind == "weight":
            v.mul_(1.0 / float(torch.Size(shape[1:]).numel()) ** 0.5)
        elif kind == "bias":
            v.mul_(0.02)
        out[name] = v
    return out


@torch.no_grad()
def load(model: nn.Module, weights: dict) -> None:
    """Copy ``weights`` into ``model``'s parameters, every name matched."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(weights) ^ set(params))[:5]
        raise KeyError(f"the weights and the model name different parameters: {missing}")
    for name, p in params.items():
        p.copy_(weights[name])
