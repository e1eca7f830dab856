"""Diffusion frameworks and the strided DDIM sampler, plain PyTorch.

A frozen copy of the function that ``ivid_tpu_torch/diffusion/
{frameworks,samplers}.py`` compute (the JAX package's, which the port's CPU
tests hold it to): eps prediction with classifier-free guidance over one
batched forward of ``[cond; null]``, the inpainting framework's packing with
fresh noise in the unseen regions, the eps-MSE training loss, and strided
DDIM with the 3D pipeline's pred-x0 edits. Every draw goes through a noise
source in the JAX package's key layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from port_bench.reference import schedules as sched

KINDS = ("GaussianDiffusion", "ClassifierFreeGuidance", "InpaintCFG")


class Framework:
    """A UNet (``model(x, t, classes)``) with a schedule and the packing and
    guidance of the framework ``kind``."""

    def __init__(self, kind: str, model, args: dict, device):
        if kind not in KINDS:
            raise NotImplementedError(f"framework {kind!r}")
        self.kind = kind
        self.model = model
        args = dict(args)
        self.schedule = sched.Schedule.create(args.pop("beta_schedule", "linear"),
                                              args.pop("timesteps", 1000), device=device)
        self.p_uncond = float(args.get("p_uncond", 0.0)) if kind != "GaussianDiffusion" else 0.0
        if float(args.get("p_uncond_img", 0.0) or 0.0) > 0:
            raise NotImplementedError("p_uncond_img > 0")

    def pack_inputs(self, rng, x, cond):
        if self.kind != "InpaintCFG":
            return x
        y, mask = cond["y"], cond["mask"]
        y_rgb, y_depth = y[..., :3], y[..., 3:]
        mask_rgb = cond.get("mask_rgb")
        rng_rgb, rng_depth = rng.split()
        parts = [x]
        if mask_rgb is not None:
            parts.append(mask_rgb)
        else:
            mask_rgb = mask
        parts.append(y_rgb * mask_rgb + rng_rgb.normal(y_rgb.shape) * (1 - mask_rgb))
        parts.append(y_depth * mask + rng_depth.normal(y_depth.shape) * (1 - mask))
        parts.append(mask)
        return torch.cat(parts, dim=-1)

    def model_inference(self, rng, x, t, cond, guidance):
        cond = cond or {}
        packed = self.pack_inputs(rng, x, cond)
        classes = cond.get("classes")
        if self.kind != "GaussianDiffusion" and guidance > 0 and classes is not None:
            x2 = torch.cat([packed, packed], dim=0)
            t2 = torch.cat([t, t], dim=0)
            c2 = torch.cat([classes, -torch.ones_like(classes)], dim=0)
            eps_c, eps_u = self.model(x2, t2, c2).chunk(2, dim=0)
            return (1 + guidance) * eps_c - guidance * eps_u
        return self.model(packed, t, classes)

    def training_loss(self, rng, batch):
        """The eps-MSE at a uniform random timestep (labels dropped to the
        null class with ``p_uncond``)."""
        x_0 = batch["x_0"]
        rng_t, rng_n, rng_pack, rng_drop = rng.split(4)
        t = rng_t.randint((x_0.shape[0],), 0, self.schedule.timesteps).to(x_0.device)
        noise = rng_n.normal(x_0.shape).to(x_0)
        x_t = sched.diffuse(self.schedule, x_0, t, noise)
        classes = batch.get("classes")
        if classes is not None and self.p_uncond:
            drop = rng_drop.uniform(classes.shape).to(classes.device) < self.p_uncond
            classes = torch.where(drop, -torch.ones_like(classes), classes)
        pred = self.model(self.pack_inputs(rng_pack, x_t, batch), t, classes)
        return torch.mean(torch.square(pred - noise))


@dataclasses.dataclass(frozen=True)
class PredX0Edits:
    replace_rgb: Optional[Tuple[float, torch.Tensor, torch.Tensor]] = None
    replace_depth: Optional[Tuple[float, torch.Tensor, torch.Tensor]] = None
    constrain_depth: Optional[Tuple[float, torch.Tensor]] = None


def apply_pred_x0_edits(pred_x_0, edits: Optional[PredX0Edits], nonzero_mask):
    if edits is None:
        return pred_x_0
    rgb, depth = pred_x_0[..., :3], pred_x_0[..., 3:]
    if edits.replace_rgb is not None:
        w, tgt, mask = edits.replace_rgb
        blended = (w * tgt + (1 - w) * rgb) * mask + rgb * (1 - mask)
        rgb = (1 - nonzero_mask) * rgb + nonzero_mask * blended
    if edits.replace_depth is not None:
        w, tgt, mask = edits.replace_depth
        depth = (w * tgt + (1 - w) * depth) * mask + depth * (1 - mask)
        if edits.constrain_depth is not None:
            cw, convex = edits.constrain_depth
            constrained = cw * torch.maximum(depth, convex) + (1 - cw) * depth
            depth = depth * mask + constrained * (1 - mask)
    return torch.cat([rgb, depth], dim=-1)


@torch.no_grad()
def ddim_sample(fw: Framework, rng, *, num=None, image_size=None, noise=None, cond=None,
                guidance=0.0, steps=None, edits: Optional[PredX0Edits] = None):
    """Strided DDIM (eta 0): step pairs ``(jump·(i+1), jump·i)`` for ``i =
    steps-1 … 0``, the model evaluated at ``t - 1``. Returns x_0."""
    s = fw.schedule
    T = s.timesteps
    steps = T if steps is None else steps
    jump = T // steps
    if noise is None:
        rng, rng_init = rng.split()
        noise = rng_init.normal((num, image_size, image_size, 4))
    x = noise
    nd = x.dim()
    for i in range(steps - 1, -1, -1):
        t = torch.full((x.shape[0],), jump * (i + 1), dtype=torch.long, device=x.device)
        t_prev = torch.full_like(t, jump * i)
        nz = (t_prev != 0).float().reshape((-1,) + (1,) * (nd - 1))
        rng_model, rng_noise = rng.fold_in(i).split()
        eps = fw.model_inference(rng_model, x, t - 1, cond, guidance)
        pred_x_0 = sched.predict_xstart_from_eps(s, x, t - 1, eps)
        pred_x_0 = apply_pred_x0_edits(pred_x_0, edits, nz)
        eps = sched.predict_eps_from_xstart(s, x, t - 1, pred_x_0)
        alpha_bar_prev = sched.extract(s.alphas_cumprod_prev, t_prev, nd)
        # eta = 0: the step's noise draw (rng_noise) is multiplied by zero.
        x = torch.sqrt(alpha_bar_prev) * pred_x_0 + torch.sqrt(1 - alpha_bar_prev) * eps
    return x
