"""Diffusion frameworks: how conditional inputs are packed and how
classifier-free guidance composes the prediction at sampling time.

Port of ``ivid_tpu/diffusion/frameworks.py``. A framework holds a backbone
module (called ``model(x, t, classes)`` on NHWC tensors) and a noise
schedule, and defines ``training_loss(rng, batch)`` (the eps-prediction MSE
at a uniform random timestep) and ``model_inference`` (input packing and
classifier-free guidance). Batches and conditioning are dicts with
documented keys:

- ``x_0``:      [B,H,W,4] RGBD target in [-1,1] (training)
- ``classes``:  [B] int64 labels, -1 = null class (optional)
- ``y``:        partial RGBD conditioning image [B,H,W,4] (inpainting)
- ``mask``:     [B,H,W,1] visibility of ``y``'s depth
- ``mask_rgb``: [B,H,W,1] visibility of ``y``'s RGB (optional)

For super-resolution ``y`` is the low-resolution RGBD image [B,h,w,4].

Random draws go through a noise source (:mod:`ivid_tpu_torch.diffusion.noise`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ivid_tpu_torch.diffusion import schedules as sched
from ivid_tpu_torch.ops.image import resize_bilinear

Batch = Dict[str, torch.Tensor]


class GaussianDiffusion:
    """Base eps-prediction DDPM framework."""

    supports_cfg = False

    def __init__(self, model, schedule: sched.Schedule):
        self.model = model
        self.schedule = schedule

    def pack_inputs(self, rng, x, cond: Batch):
        """Concatenate conditional channels onto the noisy input."""
        del rng, cond
        return x

    def _classes(self, cond: Optional[Batch]):
        return cond.get("classes") if cond else None

    def model_inference(self, rng, x, t, cond: Optional[Batch] = None,
                        guidance: float = 0.0) -> torch.Tensor:
        """Predict eps(x_t, t). With ``guidance > 0`` and class labels present,
        ``(1+s)·eps(cond) − s·eps(null)`` from one batched forward over
        ``concat([cond, null])``."""
        cond = cond or {}
        packed = self.pack_inputs(rng, x, cond)
        classes = self._classes(cond)
        if self.supports_cfg and guidance and guidance > 0 and classes is not None:
            x2 = torch.cat([packed, packed], dim=0)
            t2 = torch.cat([t, t], dim=0)
            c2 = torch.cat([classes, -torch.ones_like(classes)], dim=0)
            eps_c, eps_u = self.model(x2, t2, c2).chunk(2, dim=0)
            return (1 + guidance) * eps_c - guidance * eps_u
        return self.model(packed, t, classes)

    def p_uncond_train(self) -> float:
        return 0.0

    def _drop_classes(self, rng, classes, p_uncond):
        if classes is None or not p_uncond:
            return classes
        drop = rng.uniform(classes.shape).to(classes.device) < p_uncond
        return torch.where(drop, -torch.ones_like(classes), classes)

    def _noised(self, rng_t, rng_n, x_0):
        """A uniform timestep per sample, the noise, and x_t."""
        t = rng_t.randint((x_0.shape[0],), 0, self.schedule.timesteps).to(x_0.device)
        noise = rng_n.normal(x_0.shape).to(x_0)
        return t, noise, sched.diffuse(self.schedule, x_0, t, noise)

    def training_loss(self, rng, batch: Batch):
        """MSE between the predicted and the true noise at a uniform random
        timestep; returns ``(loss, {"loss", "mse"})``."""
        rng_t, rng_n, rng_pack, rng_drop = rng.split(4)
        t, noise, x_t = self._noised(rng_t, rng_n, batch["x_0"])
        classes = self._drop_classes(rng_drop, batch.get("classes"), self.p_uncond_train())
        pred_eps = self.model(self.pack_inputs(rng_pack, x_t, batch), t, classes)
        mse = torch.mean(torch.square(pred_eps - noise))
        return mse, {"loss": mse.detach(), "mse": mse.detach()}


class ClassifierFreeGuidance(GaussianDiffusion):
    """CFG: labels dropped to -1 with probability ``p_uncond`` in training."""

    supports_cfg = True

    def __init__(self, model, schedule, p_uncond: float = 0.1):
        super().__init__(model, schedule)
        self.p_uncond = p_uncond

    def p_uncond_train(self) -> float:
        return self.p_uncond


class InpaintCFG(GaussianDiffusion):
    """RGBD-conditioned completion (inpainting) with CFG.

    Packs ``[x_t(4), mask_rgb(1), y_rgb·m_rgb + n·(1−m_rgb)(3),
    y_depth·m + n·(1−m)(1), mask(1)]`` (10 channels), with FRESH Gaussian noise
    in the unseen regions at every call; without ``mask_rgb`` 9 channels
    (rgb masked by ``mask``)."""

    supports_cfg = True

    def __init__(self, model, schedule, p_uncond: float = 0.1, p_uncond_img: float = 0.0):
        super().__init__(model, schedule)
        self.p_uncond = p_uncond
        self.p_uncond_img = p_uncond_img

    def pack_inputs(self, rng, x, cond):
        y, mask = cond["y"], cond["mask"]
        y_rgb, y_depth = y[..., :3], y[..., 3:]
        mask_rgb = cond.get("mask_rgb")
        rng_rgb, rng_depth = rng.split()
        parts = [x]
        if mask_rgb is not None:
            parts.append(mask_rgb)
        else:
            mask_rgb = mask
        noise_rgb = rng_rgb.normal(y_rgb.shape)
        parts.append(y_rgb * mask_rgb + noise_rgb * (1 - mask_rgb))
        noise_depth = rng_depth.normal(y_depth.shape)
        parts.append(y_depth * mask + noise_depth * (1 - mask))
        parts.append(mask)
        return torch.cat(parts, dim=-1)

    def p_uncond_train(self) -> float:
        return self.p_uncond

    def pack_uncond_inputs(self, rng, x):
        """The fully unconditioned 9-channel packing: x, noise, a zero mask."""
        noise = rng.normal(x.shape).to(x)
        return torch.cat([x, noise, torch.zeros_like(x[..., :1])], dim=-1)

    def training_loss(self, rng, batch: Batch):
        """With ``p_uncond_img > 0`` the image condition is dropped per sample
        with that probability (its 9-channel packing without ``mask_rgb``);
        otherwise the base loss."""
        if not (self.p_uncond_img and self.p_uncond_img > 0):
            return super().training_loss(rng, batch)
        x_0 = batch["x_0"]
        rng_t, rng_n, rng_pack, rng_drop, rng_img, rng_u = rng.split(6)
        t, noise, x_t = self._noised(rng_t, rng_n, x_0)
        classes = self._drop_classes(rng_drop, batch.get("classes"), self.p_uncond)
        cond_in = self.pack_inputs(rng_pack, x_t, {"y": batch["y"], "mask": batch["mask"]})
        uncond_in = self.pack_uncond_inputs(rng_u, x_t)
        drop = rng_img.uniform((x_0.shape[0], 1, 1, 1)).to(x_0.device) < self.p_uncond_img
        pred_eps = self.model(torch.where(drop, uncond_in, cond_in), t, classes)
        mse = torch.mean(torch.square(pred_eps - noise))
        return mse, {"loss": mse.detach(), "mse": mse.detach()}


class SuperResCFG(ClassifierFreeGuidance):
    """Super-resolution with CFG: the low-resolution RGBD ``y`` is upsampled
    to the model's size (bilinear, half-pixel-centred, as
    ``jax.image.resize``) and concatenated after ``x_t`` (8 channels)."""

    def pack_inputs(self, rng, x, cond):
        del rng
        y_up = resize_bilinear(cond["y"], x.shape[1], x.shape[2])
        return torch.cat([x, y_up.to(x)], dim=-1)


FRAMEWORKS = {
    "GaussianDiffusion": GaussianDiffusion,
    "ClassifierFreeGuidance": ClassifierFreeGuidance,
    "InpaintCFG": InpaintCFG,
    "SuperResCFG": SuperResCFG,
}


def build_framework(name: str, model, args: dict, device=None):
    """A framework from a reference-schema config section."""
    args = dict(args)
    timesteps = args.pop("timesteps", 1000)
    beta_schedule = args.pop("beta_schedule", "linear")
    schedule = sched.Schedule.create(beta_schedule, timesteps, device=device)
    if name not in FRAMEWORKS:
        raise NotImplementedError(f"framework {name!r} is not ported yet")
    return FRAMEWORKS[name](model, schedule, **args)
