"""The super-resolution cascade's sampling, plain PyTorch.

A frozen copy of what ``ivid_tpu_torch/sr.py:upsample_views`` computes with
the ``SuperResCFG`` framework: each low-resolution RGBD view ``y`` (in [-1,
1]) is upsampled bilinearly with half-pixel centres to the model's size and
concatenated after ``x_t`` (8 input channels); every guided step runs one
batched forward of ``[class; null class -1]`` and takes ``(1 + s)·eps_c −
s·eps_u``; strided DDIM (eta 0) runs from an ``x_T`` drawn for each chunk of
views from the chunk's noise source, as the port's sampler draws it.

Departures from the published description (``diffusion/frameworks/
sr_cfg.py`` and ``sr.py`` of https://github.com/JeffreyXiang/ivid):

- Float32 throughout with TF32 off (inside :func:`upsample_views`); the
  published model runs its torso in float16 (``use_fp16``), the port in
  bfloat16. ``precision`` "fp8" is the control, one step below bfloat16.
- A chunk is computed in blocks of ``block`` views, each block's DDIM chain
  from its rows of the chunk's ``x_T``, so that the plain attention at
  T = 4096 fits on one card: the UNet computes each row alone, so the
  result is the chunk's up to the order of sums. ``first`` computes only a
  scene's first views (a check of one ring of a ``3x9`` scene).
- ``x_T`` comes from the benchmark's noise source (the JAX package's key
  layout), not from ``torch.randn`` on the global generator.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from port_bench.device import exact_f32
from port_bench.reference import diffusion


class SuperResFramework(diffusion.Framework):
    """``SuperResCFG``: classifier-free guidance over the class label, the
    low-resolution view upsampled and packed after ``x_t``."""

    def __init__(self, model, args: dict, device):
        super().__init__("ClassifierFreeGuidance", model, args, device)
        self.kind = "SuperResCFG"

    def pack_inputs(self, rng, x, cond):
        y = cond["y"].permute(0, 3, 1, 2)
        y_up = F.interpolate(y, size=(x.shape[1], x.shape[2]), mode="bilinear",
                             align_corners=False)
        return torch.cat([x, y_up.permute(0, 2, 3, 1).to(x)], dim=-1)


@torch.no_grad()
def upsample_views(fw: SuperResFramework, views, *, classes, noise, steps: int,
                   guidance: float, batchsize: int, image_size: int, block: int,
                   first: Optional[int] = None):
    """``views`` [V, s, s, 4] in [0, 1] upsampled to [V, S, S, 4] in [0, 1]:
    chunks of ``batchsize`` views, ``noise(i)`` the source of the chunk that
    starts at view ``i``, the class ``classes`` (an int; None samples without
    guidance), each chunk computed ``block`` views at a time. With
    ``first``, only the first ``first`` views are computed (each chunk's
    ``x_T`` is still drawn whole, so they are the same views)."""
    first = len(views) if first is None else min(first, len(views))
    out = []
    with exact_f32():
        for i in range(0, first, batchsize):
            y = views[i:i + batchsize] * 2 - 1
            rng, rng_init = noise(i).split()
            x_t = rng_init.normal((y.shape[0], image_size, image_size, 4)).to(y.device)
            y = y[:first - i]
            for j in range(0, y.shape[0], block):
                cond, scale = {"y": y[j:j + block]}, 0.0
                if classes is not None:
                    cond["classes"] = torch.full((cond["y"].shape[0],), classes,
                                                 dtype=torch.long, device=y.device)
                    scale = guidance
                x = diffusion.ddim_sample(fw, rng, noise=x_t[j:j + block], cond=cond,
                                          guidance=scale, steps=steps)
                out.append(x * 0.5 + 0.5)
    return torch.cat(out)
