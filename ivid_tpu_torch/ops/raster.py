"""Window-space vertex projection for the z-buffer rasterizers (GL viewport
conventions: y up, window depth ``d = (ndc.z + 1) / 2``). Port of
``ivid_tpu/ops/raster.py:project_vertices``."""

from __future__ import annotations

from typing import Tuple

import torch


def project_vertices(
    positions: torch.Tensor, mvp: torch.Tensor, render_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window-space vertices from world positions [..., V, 3] and clip
    transforms [..., 4, 4]. Returns ``(win [..., V, 3], w [..., V])`` with
    ``win = (x_px, y_px, d)``, y up, ``d`` in [0, 1] inside the depth range."""
    ones = torch.ones(positions.shape[:-1] + (1,), dtype=positions.dtype,
                      device=positions.device)
    clip = torch.matmul(torch.cat([positions, ones], dim=-1), mvp.transpose(-1, -2))
    w = clip[..., 3]
    safe_w = torch.where(w.abs() < 1e-9, torch.full_like(w, 1e-9), w)
    ndc = clip[..., :3] / safe_w[..., None]
    win = torch.stack(
        [
            (ndc[..., 0] + 1.0) * 0.5 * render_size,
            (ndc[..., 1] + 1.0) * 0.5 * render_size,
            (ndc[..., 2] + 1.0) * 0.5,
        ],
        dim=-1,
    )
    return win, w
