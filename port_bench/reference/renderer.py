"""Mesh renderers: the textured single-mesh raster of the warp and the
weighted multi-view aggregation render.

:func:`render_simple_batch` ports the hybrid form of
``ivid_tpu/ops/renderer.py``'s textured raster (the form every warp caller
pins): interior faces become barycentric-lattice fragments resolved by the
z-buffer resolve, and the frustum-padding skirt ring (the only large
triangles of a depth mesh) goes through the exact per-pixel dense raster;
the nearer source wins per pixel. Fragment alpha is zero on back faces and
edge-flagged faces, whose depth still writes.

The aggregation is the port of the full-mode aggregation: each view
slot's mesh is rasterized into its own z-buffer (occlusion is per view) by ONE
batched dense-raster launch over all slots, the per-fragment view-angle weight
``exp(-20·acos(dir·normal))`` with the eroded/edge/padding down-weighting is
evaluated per resolved pixel (the aggregation fragment shader), and the slots
are fused by the aggregation compute shader's accumulation, including its
near-zero-weight depth-max branch. Window depth follows GL exactly (affine
window z, clear depth 1.0, '<' test).

A frozen copy of ``ivid_tpu_torch/ops/renderer.py`` (its plain versions only).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import camera as cam
from port_bench.reference import raster
from port_bench.reference import raster_dense
from port_bench.reference.geometry import Mesh, rdiv


def _ring_face_split(grid_size: int):
    """Static face-index split ``(interior_faces, ring_faces)`` of a grid
    mesh; faces ``2k``/``2k+1`` triangulate grid cell ``k``."""
    n = grid_size - 1
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ring = (i == 0) | (i == n - 1) | (j == 0) | (j == n - 1)
    cells = np.arange(n * n)
    expand = lambda c: np.stack([2 * c, 2 * c + 1], -1).reshape(-1)
    return expand(cells[~ring.reshape(-1)]), expand(cells[ring.reshape(-1)])


def _simple_payload(attrs: torch.Tensor, front: torch.Tensor) -> torch.Tensor:
    """render_simple's per-fragment payload (u, v, alpha, frontness): back
    faces write black with zero alpha, edge-flagged front faces their texture
    with zero alpha; both still write depth."""
    frontb = front if front.dtype == torch.bool else front > 0.5
    alpha = (frontb & (attrs[..., 2] <= 0.999)).float()
    return torch.cat([attrs[..., 0:2], alpha[..., None], frontb.float()[..., None]], dim=-1)


def simple_fragments(mesh: Mesh, modelview: torch.Tensor, fov: float, render_size: int,
                     near: float, far: float, interior_level: int = 4,
                     has_skirt: bool = True) -> dict:
    """The raster inputs of :func:`render_simple_batch`: ``fragments`` (one
    batch of the interior faces' fragments with global pixel ids) and their
    ``payload``, the projected ``win``/``w``/``attrs`` and, with
    ``has_skirt``, the ``ring`` faces [B,T,3] for the dense pass."""
    B = mesh.positions.shape[0]
    r = render_size
    grid_size = int(round(np.sqrt(mesh.positions.shape[1])))
    proj = cam.perspective(fov, 1.0, near, far, device=modelview.device)
    win, w = raster.project_vertices(mesh.positions, proj @ modelview, r)
    attrs = torch.cat([mesh.uv, _unpacked_flags(mesh.flag)[..., :1]], dim=-1)  # uv, edge

    int_faces, ring_faces = mesh.faces, None
    if has_skirt:
        int_idx, ring_idx = _ring_face_split(grid_size)
        int_faces = mesh.faces[:, torch.from_numpy(int_idx).to(mesh.faces.device)]
        ring_faces = mesh.faces[:, torch.from_numpy(ring_idx).to(mesh.faces.device)]

    frag = raster.generate_fragments(win, w, attrs, int_faces, r, interior_level)
    off = (torch.arange(B, device=win.device) * (r * r))[:, None]
    flat = raster.FragmentBatch(
        pixel=torch.where(frag.valid, frag.pixel + off, torch.full_like(frag.pixel, B * r * r)),
        depth=frag.depth, attrs=frag.attrs, front=frag.front, valid=frag.valid,
    )
    return {"fragments": flat, "payload": _simple_payload(flat.attrs, flat.front),
            "win": win, "w": w, "attrs": attrs, "ring": ring_faces}


def render_simple_batch(mesh: Mesh, color: torch.Tensor, modelview: torch.Tensor,
                        fov: float = 45.0, render_size: int = 384, near: float = 0.01,
                        far: float = 200.0, interior_level: int = 4,
                        has_skirt: bool = True) -> dict:
    """B independent textured renders in one resolve and one dense launch.
    ``mesh`` leaves carry a leading batch axis ([B,V,3] positions, [B,F,3]
    faces: the diagonal split differs per sample); ``color`` [B,s,s,3];
    ``modelview`` [B,4,4]. Interior-face fragments get global pixel ids
    ``b·R² + y·R + x`` and resolve as B framebuffers at once; with
    ``has_skirt`` the skirt rings go through one batched dense raster.
    Returns ``color`` [B,R,R,3], ``depth`` [B,R,R,1] linearized with this
    renderer's near/far, and ``mask`` [B,R,R,1] bool."""
    B = mesh.positions.shape[0]
    r = render_size
    f = simple_fragments(mesh, modelview, fov, r, near, far, interior_level, has_skirt)
    fb, depth_win, covered = raster.resolve_zbuffer([f["fragments"]], [f["payload"]], r,
                                                    num_buffers=B)
    fb = fb.reshape(B, r, r, -1)
    depth_win = depth_win.reshape(B, r, r)
    covered = covered.reshape(B, r, r)
    if f["ring"] is not None:
        sk = raster_dense.rasterize_tris_dense_batched(f["win"], f["w"], f["attrs"], f["ring"], r)
        fb, depth_win, covered = raster_dense.merge_dense(
            fb, depth_win, covered, _simple_payload(sk.attrs, sk.front), sk, r
        )
    front_mask = fb[..., 3:4] > 0.5
    rgb = _texture_nearest(color, fb[..., 0:2]) * front_mask
    depth = rdiv(near * far, far - depth_win * (far - near))
    return {"color": rgb, "depth": depth[..., None], "mask": fb[..., 2:3] > 0.5}


def _texture_nearest(color: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """GL_NEAREST clamp-to-edge lookup of ``color`` [N, s, s, C] at ``uv``
    [N, R, R, 2]; ``uv.y`` indexes image rows directly."""
    n, s = color.shape[0], color.shape[1]
    j = torch.clamp(torch.floor(uv[..., 0] * s).long(), 0, s - 1)
    i = torch.clamp(torch.floor(uv[..., 1] * s).long(), 0, s - 1)
    idx = (i * s + j).reshape(n, -1)
    flat = color.reshape(n, s * s, -1)
    out = torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[-1]))
    return out.reshape(uv.shape[:-1] + (flat.shape[-1],))


def _unpacked_flags(flag: torch.Tensor) -> torch.Tensor:
    """Per-vertex flag bits → (edge, padding, eroded) floats, interpolated like
    GL varyings."""
    edge = torch.remainder(flag, 2.0)
    padding = torch.remainder(torch.floor(flag / 2.0), 2.0)
    eroded = torch.remainder(torch.floor(flag / 4.0), 2.0)
    return torch.stack([edge, padding, eroded], dim=-1)


def _aggregation_attrs(meshes: Mesh) -> torch.Tensor:
    """Per-vertex aggregation varyings [..., V, 11]: uv(2), edge/pad/eroded
    flags(3), world position(3), normalized normal(3)."""
    flags = _unpacked_flags(meshes.flag)
    nrm = meshes.normal / torch.clamp(
        torch.linalg.vector_norm(meshes.normal, dim=-1, keepdim=True), min=1e-12
    )
    return torch.cat([meshes.uv, flags, meshes.positions, nrm], dim=-1)


def _agg_alpha(edge, padding, eroded, wgt_raw, front):
    """Aggregation fragment-shader weight clamps; back faces (when not
    discarded) write depth with zero weight."""
    wgt = torch.clamp(wgt_raw, min=1e-4)
    wgt = torch.where(eroded >= 0.999, wgt * 1e-8, wgt)
    wgt = torch.where((padding > 0.001) | (edge > 0.999), torch.full_like(wgt, 1e-16), wgt)
    wgt = torch.clamp(wgt, min=1e-16)
    return torch.where(front, wgt, torch.zeros_like(wgt))


def _agg_alpha_from_attrs(attrs: torch.Tensor, front: torch.Tensor,
                          sample_camera: torch.Tensor) -> torch.Tensor:
    """Fragment weight from interpolated varyings ``attrs`` [..., 11]: the
    view direction and normal are recomputed per fragment."""
    edge, padding, eroded = attrs[..., 2], attrs[..., 3], attrs[..., 4]
    pos = attrs[..., 5:8]
    nrm = attrs[..., 8:11]
    direction = sample_camera - pos
    direction = direction / torch.clamp(
        torch.linalg.vector_norm(direction, dim=-1, keepdim=True), min=1e-12
    )
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), min=1e-12)
    cos = torch.clamp((direction * nrm).sum(dim=-1), 0.0, 1.0)
    wgt_raw = torch.exp(torch.clamp(-20.0 * torch.arccos(cos), min=-50.0))
    return _agg_alpha(edge, padding, eroded, wgt_raw, front)


def _aggregation_view_buffers_all(meshes: Mesh, colors: torch.Tensor,
                                  modelview: torch.Tensor, projection: torch.Tensor,
                                  render_size: int):
    """All N view slots rastered into their own z-buffers by one batched dense
    launch. ``meshes`` leaves carry a leading slot axis N; ``modelview`` is one
    render camera [4,4] or one per slot [N,4,4]. Returns (rgb [N,R,R,3],
    alpha [N,R,R], window depth [N,R,R]) in image row order."""
    n = meshes.positions.shape[0]
    r = render_size
    grid_size = int(round(np.sqrt(meshes.positions.shape[1])))
    attrs = _aggregation_attrs(meshes)
    mvp = projection @ modelview
    if mvp.dim() == 2:
        mvp = mvp.expand(n, 4, 4)
    win, w = raster.project_vertices(meshes.positions, mvp, r)
    sample_cams = cam.camera_position(meshes.modelview)  # [N, 3]
    sk = raster_dense.rasterize_grid_dense_batched(
        win, w, attrs, meshes.positions, grid_size, r, discard_attr=3
    )
    a = sk.attrs.reshape(n, r * r, -1)
    alpha = _agg_alpha_from_attrs(a, sk.front.reshape(n, r * r), sample_cams[:, None, :])
    covered = sk.covered.reshape(n, r * r)
    alpha = torch.where(covered, alpha, torch.zeros_like(alpha))
    depth_win = torch.where(covered, sk.depth.reshape(n, r * r), torch.ones_like(alpha))
    uv = torch.flip(a[..., 0:2].reshape(n, r, r, 2), dims=[1])
    alpha = torch.flip(alpha.reshape(n, r, r), dims=[1])
    depth_win = torch.flip(depth_win.reshape(n, r, r), dims=[1])
    cov = torch.flip(covered.reshape(n, r, r), dims=[1])
    rgb = _texture_nearest(colors, uv) * cov[..., None]
    return rgb, alpha, depth_win


def _agg_init_state(shape, device):
    z = lambda *extra: torch.zeros(shape + extra, dtype=torch.float32, device=device)
    return (z(3), z(), z(), z(), z(), z())


def _agg_accumulate_step(state, rgb, alpha, d):
    """One view's aggregation compute-shader accumulation."""
    acc_rgb, acc_a, acc_d, acc_dw, acc_md, acc_mc = state
    weight_color = alpha
    weight_depth = torch.where(
        alpha > 1e-14, torch.ones_like(alpha),
        torch.where(alpha > 0.0, torch.full_like(alpha, 1e-8), torch.zeros_like(alpha)),
    )
    mask_color = (alpha > 1e-6).float()
    mask_depth = (alpha > 1e-14).float()

    # Near-zero-weight depth-max branch: while only padding/edge-weight
    # fragments have accumulated, keep the farthest.
    both_pad = ((acc_dw - 1e-8).abs() < 1e-8) & ((weight_depth - 1e-8).abs() < 1e-8)
    replace = both_pad & (d * 1e-8 > acc_d)

    def upd(acc, new, add):
        return torch.where(replace, new, torch.where(both_pad, acc, acc + add))

    contrib_rgb = rgb * weight_color[..., None]
    acc_rgb = torch.where(
        replace[..., None], contrib_rgb,
        torch.where(both_pad[..., None], acc_rgb, acc_rgb + contrib_rgb),
    )
    acc_a = upd(acc_a, weight_color, weight_color)
    acc_d = upd(acc_d, d * 1e-8, d * weight_depth)
    acc_dw = upd(acc_dw, torch.full_like(acc_dw, 1e-8), weight_depth)
    acc_md = acc_md + mask_depth
    acc_mc = acc_mc + mask_color
    return (acc_rgb, acc_a, acc_d, acc_dw, acc_md, acc_mc)


def _agg_readback(state, near, far):
    """Readback normalization of the accumulated buffers."""
    acc_rgb, acc_a, acc_d, acc_dw, acc_md, acc_mc = state
    color = torch.where(
        acc_a[..., None] > 0.0,
        acc_rgb / torch.clamp(acc_a[..., None], min=1e-24),
        torch.zeros_like(acc_rgb),
    )
    depth_win = torch.where(
        acc_dw > 0.0, acc_d / torch.clamp(acc_dw, min=1e-24), torch.zeros_like(acc_d)
    )
    depth = rdiv(near * far, far - depth_win * (far - near))
    return {
        "color": color,
        "depth": depth[..., None],
        "mask_color": (acc_mc > 0.5)[..., None],
        "mask_depth": (acc_md > 0.5)[..., None],
    }


def _accumulate_agg_buffers(rgb, alpha, d, near, far):
    """Fuse pre-rastered slots in slot order; the slot axis is dim 1
    (rgb [B,N,R,R,3], alpha and d [B,N,R,R])."""
    state = _agg_init_state(alpha.shape[:1] + alpha.shape[2:], alpha.device)
    for k in range(alpha.shape[1]):
        state = _agg_accumulate_step(state, rgb[:, k], alpha[:, k], d[:, k])
    return _agg_readback(state, near, far)


def render_aggregation_batch(meshes: Mesh, colors: torch.Tensor,
                             modelview: torch.Tensor, fov: float = 45.0,
                             render_size: int = 384, near: float = 0.01,
                             far: float = 200.0) -> dict:
    """Weighted multi-view fusion render of B samples with N live view slots
    each, all B·N slot rasters in one launch. ``meshes`` leaves [B, N, ...];
    ``colors`` [B, N, s, s, 3]; ``modelview`` one render camera [4,4] or one
    per sample [B,4,4]. Returns ``color`` [B,R,R,3], ``depth`` [B,R,R,1]
    (linearized), ``mask_color``/``mask_depth`` [B,R,R,1] bool.

    Every slot is live: the JAX package's fixed-slot buckets add invalid
    slots that contribute exactly nothing to the accumulation, so live slots
    alone give the same result."""
    b, n = colors.shape[0], colors.shape[1]
    r = render_size
    projection = cam.perspective(fov, 1.0, near, far, device=colors.device)
    flat = meshes.map(lambda x: x.reshape((b * n,) + x.shape[2:]))
    mv = modelview if modelview.dim() == 2 else modelview.repeat_interleave(n, dim=0)
    rgb, alpha, d = _aggregation_view_buffers_all(
        flat, colors.reshape((b * n,) + colors.shape[2:]), mv, projection, r
    )
    return _accumulate_agg_buffers(
        rgb.reshape(b, n, r, r, 3), alpha.reshape(b, n, r, r),
        d.reshape(b, n, r, r), near, far,
    )
