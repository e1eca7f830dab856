"""Image resampling ops of the condition tail, the warp augments and the SR
cascade: 8-bit-quantized Lanczos downsample, bilinear resize, strided SSAA
pick, coverage-threshold mask downsample, and the fixed- and random-sigma
Gaussian blurs.

Port of ``ivid_tpu/ops/image.py``. Images are [..., H, W, C].

A frozen copy of ``ivid_tpu_torch/ops/image.py`` (its plain versions only).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    radius = 3.0
    y = radius * torch.sin(np.pi * x) * torch.sin(np.pi * x / radius)
    den = torch.where(x != 0, np.pi ** 2 * x ** 2, torch.ones_like(x))
    w = torch.where(x > 1e-3, y / den, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(w), w)


def _resize_weights(in_size: int, out_size: int, kernel, device) -> torch.Tensor:
    """[in, out] resampling matrix of ``jax.image.resize`` with ``kernel``
    (antialiased: the kernel widens by the downscale factor; each output's
    weights normalized to sum 1, so the border clamps), computed in f32 as
    that function computes it."""
    f32 = torch.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device)


def resize_lanczos_8bit(img: torch.Tensor, out_size: int) -> torch.Tensor:
    """``PIL.Image.fromarray(to8b(x)).resize(s, LANCZOS) / 255``: quantize to
    8 bits, Lanczos-3 resample both spatial axes, re-quantize."""
    h, w = img.shape[-3], img.shape[-2]
    img8 = torch.round(torch.clamp(img, 0.0, 1.0) * 255.0)
    wh = _resize_weights(h, out_size, _lanczos3, img.device)
    ww = _resize_weights(w, out_size, _lanczos3, img.device)
    out = torch.einsum("...hwc,hH,wW->...HWc", img8, wh, ww)
    return torch.round(torch.clamp(out, 0.0, 255.0)) / 255.0


def ssaa_subsample(img: torch.Tensor, ssaa: int) -> torch.Tensor:
    """Centre-strided pick of a supersampled [..., R, R, C] buffer."""
    off = (ssaa - 1) // 2
    return img[..., off::ssaa, off::ssaa, :]


def coverage_mask(mask: torch.Tensor, ssaa: int, threshold: float = 0.75) -> torch.Tensor:
    """Downsample a supersampled boolean [..., R, R, C] mask by coverage fraction."""
    r, c = mask.shape[-3], mask.shape[-1]
    s = r // ssaa
    m = mask.reshape(mask.shape[:-3] + (s, ssaa, s, ssaa, c)).float().sum(dim=(-4, -2))
    return m > threshold * ssaa * ssaa


def _separable_blur(x: torch.Tensor, k, mode: str) -> torch.Tensor:
    """[H, W, C] convolved with the 1-D kernel ``k`` (a sequence of weights)
    along H, then W, padded by ``F.pad``'s ``mode``."""
    half = len(k) // 2
    h, w = x.shape[0], x.shape[1]
    xp = F.pad(x.permute(2, 0, 1)[None], (half, half, half, half), mode=mode)[0]
    xp = xp.permute(1, 2, 0)
    xp = sum(k[i] * xp[i:i + h, :, :] for i in range(len(k)))
    return sum(k[i] * xp[:, i:i + w, :] for i in range(len(k)))


def gaussian_blur_random_sigma(rng, x: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """cv2.GaussianBlur of [H, W, C] with sigma ~ U(0, 1) + 1e-3 drawn from
    the noise source ``rng``, and cv2's default border (reflect-101: mirrored
    without repeating the edge pixel)."""
    sigma = rng.uniform(()).to(x.device) + 1e-3
    half = kernel_size // 2
    offs = torch.arange(-half, half + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-(offs ** 2) / (2 * sigma ** 2))
    return _separable_blur(x, k / k.sum(), "reflect")
