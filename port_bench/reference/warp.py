"""The two geometry pipelines of ``ivid_tpu/ops/warp.py``.

- Multi-view condition aggregation (``aggregate_conditions_batch``,
  ``_condition_tail``): the inpainting condition of a novel view from a
  weighted render of the previously generated views.
- The forward-backward warp (``forward_backward_warp_batch``) that
  synthesizes the cond model's training pairs from still RGBD images: lift to
  a mesh, render from a jittered pose, re-lift, render back, and mask
  under-covered and depth-edge pixels.

A frozen copy of ``ivid_tpu_torch/ops/warp.py`` (its plain versions only).
"""

from __future__ import annotations

from typing import Optional

import torch

from port_bench.reference import camera as cam
from port_bench.reference import geometry as geom
from port_bench.reference import image as im
from port_bench.reference import renderer as rend


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


def default_modelview(device=None) -> torch.Tensor:
    """The canonical first-view camera at (0, 0, 1) looking at the origin."""
    return cam.look_at(torch.tensor([0.0, 0.0, 1.0], device=device),
                       torch.zeros(3, device=device),
                       torch.tensor([0.0, 1.0, 0.0], device=device))


def forward_backward_warp_batch(
    rgbd: torch.Tensor,
    modelview1: torch.Tensor,
    modelview0: Optional[torch.Tensor] = None,
    padding=None,
    fov: float = 45.0,
    near: float = 0.5,
    far: float = 100.0,
    mode: str = "z_buffer",
    atol: float = 0.02,
    rtol: float = 0.02,
    ssaa: int = 3,
    render_near: float = 0.1,
    render_far: float = 200.0,
) -> dict:
    """Warp B RGBD images to their ``modelview1`` and back, two batched
    renders for the whole batch. ``rgbd`` [B,s,s,4] with color in [0,1] and
    depth stored per ``mode`` in [0,1]; ``modelview1`` [B,4,4]
    (``modelview0`` likewise, default canonical). The first view is lifted
    with a ``padding`` skirt, rendered from view 1 at ``s·ssaa``, re-lifted
    with discontinuity flags and rendered back. Returns ``color``/``depth``/
    ``mask`` [B,s,s,·] with unseen pixels zeroed."""
    B, s = rgbd.shape[0], rgbd.shape[1]
    r = s * ssaa
    if modelview0 is None:
        modelview0 = default_modelview(rgbd.device).expand(B, 4, 4)
    mesh0 = geom.stack_meshes([
        geom.depth_to_mesh(geom.linearize_depth(rgbd[i, ..., 3:], near, far, mode),
                           padding=padding, fov=fov, modelview=modelview0[i])
        for i in range(B)
    ])
    res = rend.render_simple_batch(mesh0, rgbd[..., :3], modelview1, fov, r,
                                   render_near, render_far, has_skirt=padding is not None)
    color1 = im.resize_lanczos_8bit(res["color"], s)
    depth1 = im.ssaa_subsample(res["depth"], ssaa)

    mesh1 = geom.stack_meshes([
        geom.depth_to_mesh(depth1[i], padding=None, fov=fov, modelview=modelview1[i],
                           atol=atol, rtol=rtol)
        for i in range(B)
    ])
    res = rend.render_simple_batch(mesh1, color1, modelview0, fov, r,
                                   render_near, render_far, has_skirt=False)
    color = im.resize_lanczos_8bit(res["color"], s)
    depth = geom.project_depth(im.ssaa_subsample(res["depth"], ssaa), near, far, mode)
    mask = im.coverage_mask(res["mask"], ssaa) & geom.depth_edge(depth, atol=atol, rtol=rtol)
    maskf = mask.float()
    return {"color": color * maskf, "depth": depth * maskf, "mask": maskf}
