"""Diffusion noise schedules and per-timestep coefficient tables.

Tables are computed in float64 numpy and stored as float32 tensors, as the
JAX package (``ivid_tpu/diffusion/schedules.py``) and the reference build
them. ``t`` ranges over ``[0, T)`` where ``t = 0`` is one diffusion step.
Images are NHWC.

A frozen copy of ``ivid_tpu_torch/diffusion/schedules.py`` (its plain versions only).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def linear_betas(timesteps: int) -> np.ndarray:
    """Linear betas (Ho et al.), scaled so the limit is step-count invariant."""
    scale = 1000 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def betas_for_alpha_bar(timesteps: int, alpha_bar: Callable[[float], float],
                        max_beta: float = 0.999) -> np.ndarray:
    t = np.arange(timesteps, dtype=np.float64)
    a1 = np.array([alpha_bar(x) for x in t / timesteps])
    a2 = np.array([alpha_bar(x) for x in (t + 1) / timesteps])
    return np.minimum(1 - a2 / a1, max_beta)


def cosine_betas(timesteps: int) -> np.ndarray:
    """Improved-DDPM cosine schedule."""
    return betas_for_alpha_bar(
        timesteps, lambda t: np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
    )


def get_betas(name: str, timesteps: int) -> np.ndarray:
    if name == "linear":
        return linear_betas(timesteps)
    if name == "cosine":
        return cosine_betas(timesteps)
    raise ValueError(f"unknown beta schedule: {name!r}")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Coefficient tables of q(x_t | x_0), the posterior q(x_{t-1} | x_t, x_0)
    and the eps <-> x_0 conversions, each ``[T]`` float32."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def timesteps(self) -> int:
        return self.betas.shape[0]

    @classmethod
    def create(cls, name: str = "linear", timesteps: int = 1000, device=None) -> "Schedule":
        betas = get_betas(name, timesteps)
        assert betas.ndim == 1
        assert ((betas > 0) & (betas <= 1)).all()
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
            posterior_variance=f32(post_var),
            # Clipped because the posterior variance is 0 at t=0.
            posterior_log_variance_clipped=f32(np.log(np.append(post_var[1], post_var[1:]))),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        )


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients for ``t`` [B] as ``[B, 1, ..., 1]``."""
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def diffuse(schedule: Schedule, x_0, t, noise):
    """A sample of q(x_t | x_0) for the given ``noise``."""
    nd = x_0.dim()
    return (extract(schedule.sqrt_alphas_cumprod, t, nd) * x_0
            + extract(schedule.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def predict_xstart_from_eps(schedule: Schedule, x_t, t, eps):
    nd = x_t.dim()
    return (extract(schedule.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - extract(schedule.sqrt_recipm1_alphas_cumprod, t, nd) * eps)


def predict_eps_from_xstart(schedule: Schedule, x_t, t, x_0):
    nd = x_t.dim()
    return ((extract(schedule.sqrt_recip_alphas_cumprod, t, nd) * x_t - x_0)
            / extract(schedule.sqrt_recipm1_alphas_cumprod, t, nd))
