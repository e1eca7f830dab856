"""Reverse-process samplers: ancestral DDPM and strided DDIM with the guided
pred-x0 edits of the 3D pipeline.

Port of ``ivid_tpu/diffusion/samplers.py`` as plain Python loops over the
timesteps (PyTorch runs eagerly, so the JAX package's scan chunking has no
counterpart). The per-step noise derivation follows the JAX samplers:
``fold_in(rng, step)`` then ``split`` into the model's and the step's noise.
Under torch.profiler each step is a ``sampler.step`` span.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ivid_tpu_torch.diffusion import schedules as sched
from ivid_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class PredX0Edits:
    """3D-consistency edits applied to pred_x_0 at every DDIM step.

    - ``replace_rgb``: (weight, rgb [B,H,W,3], mask [B,H,W,1]): blend known RGB
      into pred_x0 over unmasked pixels (skipped on the final step).
    - ``replace_depth``: (weight, depth [B,H,W,1], mask [B,H,W,1]).
    - ``constrain_depth``: (weight, convex [B,H,W,1]): outside the depth mask,
      pull the predicted depth up to at least the convex-hull depth.
    """

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


def _nonzero_mask(t, ndim):
    return (t != 0).float().reshape((-1,) + (1,) * (ndim - 1))


def _initial_noise(rng, noise, num, image_size):
    """x_T: ``noise`` if given, else a [num, s, s, 4] draw split off ``rng``."""
    if noise is not None:
        return rng, noise
    if num is None or image_size is None:
        raise ValueError("give either noise or num and image_size")
    rng, rng_init = rng.split()
    return rng, rng_init.normal((num, image_size, image_size, 4))


def _result(x, traj) -> dict:
    """``samples``, and with a trajectory ``pred_x_t``/``pred_x_0`` stacked
    ``[steps, B, ...]`` in step order, as the JAX samplers' scans stack them."""
    out = {"samples": x}
    if traj is not None:
        out["pred_x_t"] = torch.stack([x_t for x_t, _ in traj])
        out["pred_x_0"] = torch.stack([x_0 for _, x_0 in traj])
    return out


@torch.no_grad()
def ddpm_sample(framework, rng, *, num=None, image_size=None, noise=None, cond=None,
                guidance=0.0, return_trajectory=False) -> dict:
    """Full-T ancestral (DDPM) sampling. ``return_trajectory`` adds each
    step's ``x_{t-1}`` (``pred_x_t``) and ``pred_x_0``."""
    s = framework.schedule
    T = s.timesteps
    rng, x = _initial_noise(rng, noise, num, image_size)
    nd = x.dim()
    traj = [] if return_trajectory else None
    for i in range(T - 1, -1, -1):
        with span("sampler.step"):
            t = torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)
            rng_model, rng_noise = rng.fold_in(i).split()
            eps = framework.model_inference(rng_model, x, t, cond, guidance)
            pred_x_0 = sched.predict_xstart_from_eps(s, x, t, eps)
            mean, _, log_var = sched.q_posterior_mean_variance(s, pred_x_0, x, t)
            z = rng_noise.normal(x.shape)
            x = mean + _nonzero_mask(t, nd) * torch.exp(0.5 * log_var) * z
            if traj is not None:
                traj.append((x, pred_x_0))
    return _result(x, traj)


@torch.no_grad()
def ddim_sample(framework, rng, *, num=None, image_size=None, noise=None, cond=None,
                guidance=0.0, steps=None, eta=0.0,
                edits: Optional[PredX0Edits] = None, return_trajectory=False) -> dict:
    """Strided DDIM with guided pred_x_0 edits. Step pairs are
    ``(jump·(i+1), jump·i)`` for ``i = steps-1 … 0`` with ``jump = T // steps``;
    the model is evaluated at ``t - 1``. ``return_trajectory`` adds each
    step's ``x_{t-1}`` (``pred_x_t``) and edited ``pred_x_0``."""
    s = framework.schedule
    T = s.timesteps
    steps = T if steps is None else steps
    if not 1 <= steps <= T:
        raise ValueError(f"steps={steps} outside [1, {T}]")
    jump = T // steps
    rng, x = _initial_noise(rng, noise, num, image_size)
    nd = x.dim()
    traj = [] if return_trajectory else None
    for i in range(steps - 1, -1, -1):
        with span("sampler.step"):
            t = torch.full((x.shape[0],), jump * (i + 1), dtype=torch.long, device=x.device)
            t_prev = torch.full_like(t, jump * i)
            nz = _nonzero_mask(t_prev, nd)
            rng_model, rng_noise = rng.fold_in(i).split()
            eps = framework.model_inference(rng_model, x, t - 1, cond, guidance)
            pred_x_0 = sched.predict_xstart_from_eps(s, x, t - 1, eps)
            pred_x_0 = apply_pred_x0_edits(pred_x_0, edits, nz)
            eps = sched.predict_eps_from_xstart(s, x, t - 1, pred_x_0)

            alpha_bar = sched.extract(s.alphas_cumprod, t - 1, nd)
            alpha_bar_prev = sched.extract(s.alphas_cumprod_prev, t_prev, nd)
            sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                     * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
            mean = (torch.sqrt(alpha_bar_prev) * pred_x_0
                    + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
            z = rng_noise.normal(x.shape)
            x = mean + nz * sigma * z
            if traj is not None:
                traj.append((x, pred_x_0))
    return _result(x, traj)
