"""Fragment z-buffer rasterizer for depth-map grid meshes: window-space
projection, barycentric-lattice fragments and the z-buffer resolve.

Port of ``ivid_tpu/ops/raster.py``. GL viewport conventions: y up, window
depth ``d = (ndc.z + 1) / 2`` (affine in screen space, so z-testing the
interpolated ``d`` matches a hardware z-buffer). Each face is sampled at a
fixed lattice of barycentric points; the resolve keeps the nearest fragment
per pixel (GL ``<``, clear depth 1.0) and averages equal-depth ties.
:func:`resolve_zbuffer` is the plain scatter resolve on any device: a frozen
copy of the port's plain version, without its CUDA kernel K3.

A frozen copy of ``ivid_tpu_torch/ops/raster.py`` (its plain versions only).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch


def barycentric_lattice(level: int) -> np.ndarray:
    """``level**2`` sample points uniformly covering the unit triangle, via the
    parallelogram fold: grid points with a+b>1 are mirrored to (1-a, 1-b)."""
    i, j = np.meshgrid(np.arange(level), np.arange(level), indexing="ij")
    a = (i.reshape(-1) + 0.5) / level
    b = (j.reshape(-1) + 0.5) / level
    flip = a + b > 1.0
    a = np.where(flip, 1.0 - a, a)
    b = np.where(flip, 1.0 - b, b)
    return np.stack([1.0 - a - b, a, b], axis=-1).astype(np.float32)  # [S, 3]


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


class FragmentBatch(NamedTuple):
    """Flat fragments ready for the z-buffer resolve (leading axes, if any,
    stack independent meshes)."""

    pixel: torch.Tensor  # [..., N] int64 flat pixel id y·R + x (y up); R² if invalid
    depth: torch.Tensor  # [..., N] window depth in [0, 1]
    attrs: torch.Tensor  # [..., N, A] perspective-correct interpolated attributes
    front: torch.Tensor  # [..., N] bool front-facing
    valid: torch.Tensor  # [..., N] bool


def gather_corners(vals: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Per-face corner values [..., F, 3, C] of vertex values [..., V, C] for
    faces [..., F, 3] (equal leading axes)."""
    lead = faces.shape[:-2]
    n = faces.shape[-2]
    idx = faces.reshape(lead + (n * 3, 1)).expand(lead + (n * 3, vals.shape[-1]))
    return torch.gather(vals, -2, idx).reshape(lead + (n, 3, vals.shape[-1]))


def generate_fragments(win: torch.Tensor, w: torch.Tensor, attrs: torch.Tensor,
                       faces: torch.Tensor, render_size: int, level: int) -> FragmentBatch:
    """``level**2`` fragments per face with perspective-correct attributes.
    ``win`` [..., V, 3], ``w`` [..., V], ``attrs`` [..., V, A], ``faces``
    [..., F, 3]; fragments come face-major, ``F·level²`` per mesh."""
    bary = torch.from_numpy(barycentric_lattice(level)).to(win.device)  # [S, 3]
    fv = gather_corners(win, faces)                      # [..., F, 3, 3]
    fw = gather_corners(w[..., None], faces)[..., 0]     # [..., F, 3]
    fa = gather_corners(attrs, faces)                    # [..., F, 3, A]

    # Front-facing via signed window area (y up, CCW front).
    e1 = fv[..., 1, :2] - fv[..., 0, :2]
    e2 = fv[..., 2, :2] - fv[..., 0, :2]
    front = (e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]) > 0.0
    # A face is valid only if fully in front of the camera (no near clipping).
    face_valid = (fw > 1e-6).all(dim=-1)

    pos = torch.einsum("sk,...fkc->...fsc", bary, fv)
    inv_w = 1.0 / fw
    num = torch.einsum("sk,...fka->...fsa", bary, fa * inv_w[..., None])
    den = torch.einsum("sk,...fk->...fs", bary, inv_w)
    interp = num / den[..., None]

    x = torch.floor(pos[..., 0]).long()
    y = torch.floor(pos[..., 1]).long()
    d = pos[..., 2]
    r = render_size
    valid = ((x >= 0) & (x < r) & (y >= 0) & (y < r) & (d >= 0.0) & (d <= 1.0)
             & face_valid[..., None])
    pixel = torch.where(valid, y * r + x, torch.full_like(x, r * r))
    lead = d.shape[:-2]
    n = d.shape[-2] * d.shape[-1]
    return FragmentBatch(
        pixel=pixel.reshape(lead + (n,)),
        depth=d.reshape(lead + (n,)),
        attrs=interp.reshape(lead + (n, interp.shape[-1])),
        front=front[..., None].expand(d.shape).reshape(lead + (n,)),
        valid=valid.reshape(lead + (n,)),
    )


def flip_to_image_rows(out, depth_win, covered, render_size: int, num_buffers: int):
    """Flat framebuffers (GL rows, bottom-up) → image rows (top-down),
    ``[R, R, ·]`` for one buffer or ``[B, R, R, ·]`` for ``num_buffers > 1``."""
    r = render_size
    lead = (num_buffers,) if num_buffers > 1 else ()
    return (
        torch.flip(out.reshape(lead + (r, r, -1)), dims=[-3]),
        torch.flip(depth_win.reshape(lead + (r, r)), dims=[-2]),
        torch.flip(covered.reshape(lead + (r, r)), dims=[-2]),
    )


def _concat(fragments: Sequence[FragmentBatch], payloads: Sequence[torch.Tensor]):
    pix = torch.cat([f.pixel.reshape(-1) for f in fragments])
    d = torch.cat([f.depth.reshape(-1) for f in fragments])
    valid = torch.cat([f.valid.reshape(-1) for f in fragments])
    payload = torch.cat([p.reshape(-1, p.shape[-1]) for p in payloads], dim=0)
    return pix, d, valid, payload


def resolve_zbuffer_scatter(fragments: Sequence[FragmentBatch],
                            payloads: Sequence[torch.Tensor], render_size: int,
                            num_buffers: int = 1):
    """Plain z-buffer resolve by two scatters (the JAX package's
    ``resolve_zbuffer_scatter``): per-pixel depth minimum, then payload and
    winner counts summed over the fragments at that depth, averaged.
    ``num_buffers``: see :func:`resolve_zbuffer`. Returns ``(payload, depth_win,
    covered)`` in image row order."""
    npix = num_buffers * render_size * render_size
    pix, d, valid, payload = _concat(fragments, payloads)
    d_masked = torch.where(valid, d, torch.full_like(d, float("inf")))
    zbuf = torch.full((npix + 1,), float("inf"), dtype=torch.float32, device=d.device)
    zbuf = zbuf.scatter_reduce(0, pix, d_masked, reduce="amin")
    winf = (valid & (d_masked <= zbuf[pix])).to(payload.dtype)
    acc = torch.zeros((npix + 1, payload.shape[-1]), dtype=payload.dtype, device=d.device)
    acc.index_add_(0, pix, payload * winf[:, None])
    cnt = torch.zeros((npix + 1,), dtype=payload.dtype, device=d.device)
    cnt.index_add_(0, pix, winf)
    out = acc[:npix] / torch.clamp(cnt[:npix], min=1.0)[:, None]
    covered = torch.isfinite(zbuf[:npix])
    depth_win = torch.where(covered, zbuf[:npix], torch.ones_like(zbuf[:npix]))
    return flip_to_image_rows(out, depth_win, covered, render_size, num_buffers)


def resolve_zbuffer(fragments: Sequence[FragmentBatch], payloads: Sequence[torch.Tensor],
                    render_size: int, num_buffers: int = 1):
    """Depth-test resolve of fragment batches with per-fragment ``payloads``
    [..., N, K], by :func:`resolve_zbuffer_scatter` on any device.
    ``num_buffers > 1`` resolves B independent framebuffers in one pass:
    fragments carry global pixel ids ``b·R² + y·R + x`` (invalid: ``B·R²``)
    and the outputs gain a leading buffer axis."""
    return resolve_zbuffer_scatter(fragments, payloads, render_size, num_buffers)
