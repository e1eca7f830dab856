"""Multi-view condition aggregation: the inpainting condition of a novel view
from a weighted render of the previously generated views. Port of
``aggregate_conditions(_batch)`` and ``_condition_tail`` of
``ivid_tpu/ops/warp.py``."""

from __future__ import annotations

import torch

from ivid_tpu_torch.ops import geometry as geom
from ivid_tpu_torch.ops import image as im
from ivid_tpu_torch.ops import renderer as rend


def aggregate_conditions_batch(
    meshes: geom.Mesh,
    colors: torch.Tensor,
    modelview: torch.Tensor,
    fov: float = 45.0,
    near: float = 0.5,
    far: float = 100.0,
    mode: str = "z_buffer",
    atol: float = 0.02,
    rtol: float = 0.02,
    erode_rgb: int = 2,
    ssaa: int = 3,
    render_near: float = 0.01,
    render_far: float = 200.0,
) -> dict:
    """Conditions of B samples' novel views in one raster launch: ``meshes``
    leaves [B, N, ...] (N live views each), ``colors`` [B, N, s, s, 3] in
    [0, 1], ``modelview`` [4,4] or [B,4,4]. Returns ``color``/``depth``/
    ``mask``/``mask_rgb``/``depth_convex`` [B, s, s, ·], depth stored per ``mode``."""
    s = colors.shape[2]
    res = rend.render_aggregation_batch(
        meshes, colors, modelview, fov, s * ssaa, render_near, render_far
    )
    return _condition_tail(res, s, ssaa, near, far, mode, atol, rtol, erode_rgb)


def aggregate_conditions(meshes: geom.Mesh, colors: torch.Tensor,
                         modelview: torch.Tensor, **kwargs) -> dict:
    """:func:`aggregate_conditions_batch` for one sample: ``meshes`` leaves
    [N, ...], ``colors`` [N, s, s, 3], ``modelview`` [4,4]."""
    res = aggregate_conditions_batch(
        meshes.map(lambda x: x[None]), colors[None], modelview, **kwargs
    )
    return {k: v[0] for k, v in res.items()}


def _condition_tail(res, s, ssaa, near, far, mode, atol, rtol, erode_rgb):
    """Supersampled render → condition images at resolution s (leading axes
    pass through)."""
    color = im.resize_lanczos_8bit(res["color"], s)
    depth = im.ssaa_subsample(res["depth"], ssaa)
    depth = geom.project_depth(depth, near, far, mode)
    mask = im.coverage_mask(res["mask_depth"], ssaa)
    mask_rgb = im.coverage_mask(res["mask_color"], ssaa)
    depth_convex = depth

    mask = mask & geom.depth_edge(depth, atol=atol, rtol=rtol)
    # cv2.erode with a (2·erode_rgb−1)² kernel == radius erode_rgb−1.
    mask_rgb = mask_rgb & (geom.erode(mask.float(), erode_rgb - 1) > 0)

    maskf = mask.float()
    mask_rgbf = mask_rgb.float()
    return {
        "color": color * mask_rgbf,
        "depth": depth * maskf,
        "mask": maskf,
        "mask_rgb": mask_rgbf,
        "depth_convex": depth_convex,
    }
