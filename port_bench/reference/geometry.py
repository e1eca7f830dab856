"""RGBD geometry: depth lifting, grid meshing, discontinuity masks, normals.

Port of ``ivid_tpu/ops/geometry.py``. The regular-grid triangulation is index
arithmetic (only the diagonal split is data dependent), so meshes have static
sizes and stack along leading axes. Flag bits match the aggregation shader's
vertex unpacking: 1 = edge, 2 = padding, 4 = eroded.

A frozen copy of ``ivid_tpu_torch/ops/geometry.py`` (its plain versions only).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import camera as cam


@dataclasses.dataclass
class Mesh:
    """A depth-map mesh. ``positions`` world-space [..., V, 3]; ``uv`` [..., V, 2]
    in [0,1]^2 indexes the source color image (u → column, v → row); ``flag``
    [..., V]; ``normal`` [..., V, 3] or None; ``faces`` [..., F, 3] int64;
    ``depth`` [..., H, W, 1] the source (unpadded) linearized depth;
    ``modelview`` [..., 4, 4]; ``fov`` in degrees. Leading axes stack views or
    samples (see :func:`stack_meshes`)."""

    positions: torch.Tensor
    uv: torch.Tensor
    flag: torch.Tensor
    normal: Optional[torch.Tensor]
    faces: torch.Tensor
    depth: torch.Tensor
    modelview: torch.Tensor
    fov: float = 45.0

    def map(self, fn) -> "Mesh":
        """Apply ``fn`` to every tensor field."""
        return Mesh(
            positions=fn(self.positions), uv=fn(self.uv), flag=fn(self.flag),
            normal=None if self.normal is None else fn(self.normal),
            faces=fn(self.faces), depth=fn(self.depth),
            modelview=fn(self.modelview), fov=self.fov,
        )


def stack_meshes(meshes, dim: int = 0) -> Mesh:
    """Stack meshes of equal shapes along a new leading axis."""
    m0 = meshes[0]
    st = lambda name: torch.stack([getattr(m, name) for m in meshes], dim=dim)
    return Mesh(
        positions=st("positions"), uv=st("uv"), flag=st("flag"),
        normal=None if m0.normal is None else st("normal"),
        faces=st("faces"), depth=st("depth"), modelview=st("modelview"),
        fov=m0.fov,
    )


def rdiv(a: float, x: torch.Tensor) -> torch.Tensor:
    """``a / x`` as one correctly rounded division (torch computes
    ``scalar / tensor`` as ``scalar * reciprocal(tensor)``, rounding twice)."""
    return torch.full_like(x, a) / x


def linearize_depth(depth, near=0.5, far=100.0, mode="z_buffer"):
    """Map stored depth to metric depth."""
    if mode == "z_buffer":
        depth = torch.clamp(depth, 1e-6, 1.0 - 1e-6)
        return rdiv(near * far, far - (far - near) * depth)
    if mode == "linear":
        return near + (far - near) * depth
    raise ValueError(mode)


def project_depth(depth, near=0.5, far=100.0, mode="z_buffer"):
    """Inverse of :func:`linearize_depth`."""
    if mode == "z_buffer":
        depth = torch.clamp(depth, near, far)
        return (1 / near - 1 / depth) / (1 / near - 1 / far)
    if mode == "linear":
        return (depth - near) / (far - near)
    raise ValueError(mode)


def image_uv(image_size: int, device=None) -> torch.Tensor:
    """Pixel-centre uv grid [H, W, 2]."""
    c = (torch.arange(image_size, dtype=torch.float32, device=device) + 0.5) / image_size
    u = c[None, :].expand(image_size, image_size)
    v = c[:, None].expand(image_size, image_size)
    return torch.stack([u, v], dim=-1)


def unproject(depth: torch.Tensor, fov: float = 45.0):
    """Lift a linearized depth map [H, W, 1] to camera-space points [H, W, 3];
    image row 0 (top) maps to +y, the camera looks down -z. Returns (points, uv)."""
    s = depth.shape[0]
    focal = 0.5 / np.tan(0.5 * np.deg2rad(fov))
    uv = image_uv(s, depth.device)
    x = (uv[..., 0] - 0.5) / focal
    y = (torch.flip(uv[..., 1], dims=[0]) - 0.5) / focal
    rays = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    return rays * depth, uv


def triangulate_face_type(points: torch.Tensor) -> torch.Tensor:
    """Diagonal split per grid cell of [..., g, g, 3] points: True picks the
    (i,j)-(i+1,j+1) diagonal when it is shorter."""
    d_main = torch.linalg.vector_norm(
        points[..., :-1, :-1, :] - points[..., 1:, 1:, :], dim=-1)
    d_anti = torch.linalg.vector_norm(
        points[..., :-1, 1:, :] - points[..., 1:, :-1, :], dim=-1)
    return d_main < d_anti


def triangulate(points: torch.Tensor) -> torch.Tensor:
    """Regular-grid triangulation [2*(S-1)^2, 3] with the data-dependent split."""
    s0, s1 = points.shape[:2]
    idx = torch.arange(s0 * s1, device=points.device).reshape(s0, s1)
    ft = triangulate_face_type(points)
    tl, tr = idx[:-1, :-1], idx[:-1, 1:]
    bl, br = idx[1:, :-1], idx[1:, 1:]
    faces = torch.stack(
        [
            tr.reshape(-1), tl.reshape(-1), torch.where(ft, br, bl).reshape(-1),
            bl.reshape(-1), br.reshape(-1), torch.where(ft, tl, tr).reshape(-1),
        ],
        dim=-1,
    )
    return faces.reshape(-1, 3)


def mask_discontinuity(faces, depths, atol=0.02, rtol=0.02):
    """Per-face discontinuity: large absolute AND inverse-depth spread."""
    d = depths.reshape(-1)[faces]
    diff = d.amax(dim=-1) - d.amin(dim=-1)
    inv = (1.0 / d).amax(dim=-1) - (1.0 / d).amin(dim=-1)
    return (diff > atol) & (inv > rtol)


def cal_depth_normal(points: torch.Tensor) -> torch.Tensor:
    """Per-pixel normals from Sobel-filtered point differences."""
    p = F.pad(points.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")
    p = p[0].permute(1, 2, 0)
    ex = p[:, 2:] - p[:, :-2]
    ey = p[:-2, :] - p[2:, :]
    ex = (ex[:-2] + 2 * ex[1:-1] + ex[2:]) / 4
    ey = (ey[:, :-2] + 2 * ey[:, 1:-1] + ey[:, 2:]) / 4
    n = torch.cross(ex, ey, dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def depth_edge(depth: torch.Tensor, atol=0.02, rtol=0.02) -> torch.Tensor:
    """4-direction depth-edge vote over [..., H, W, 1]; True where the depth is
    NOT an edge (fewer than 3 votes)."""
    d = depth[..., 0]

    def diff(a, b):
        a = torch.clamp(a, min=1e-6)
        b = torch.clamp(b, min=1e-6)
        return ((a - b).abs() > atol) & ((1 / a - 1 / b).abs() > rtol)

    mask = torch.zeros(d.shape, dtype=torch.int32, device=d.device)
    m = diff(d[..., :, 1:], d[..., :, :-1]).int()
    mask[..., :, 1:] += m
    mask[..., :, :-1] += m
    m = diff(d[..., 1:, :], d[..., :-1, :]).int()
    mask[..., 1:, :] += m
    mask[..., :-1, :] += m
    m = diff(d[..., 1:, 1:], d[..., :-1, :-1]).int()
    mask[..., 1:, 1:] += m
    mask[..., :-1, :-1] += m
    m = diff(d[..., 1:, :-1], d[..., :-1, 1:]).int()
    mask[..., 1:, :-1] += m
    mask[..., :-1, 1:] += m
    return (mask < 3)[..., None]


def erode(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Min filter with a (2r+1)^2 window over [..., H, W] or [..., H, W, 1]
    float maps; the border does not erode (cv2.erode's default)."""
    if radius <= 0:
        return mask
    squeeze = mask.shape[-1] == 1 and mask.dim() >= 3
    m = mask[..., 0] if squeeze else mask
    lead = m.shape[:-2]
    flat = m.reshape((-1, 1) + m.shape[-2:]).float()
    k = 2 * radius + 1
    out = -F.max_pool2d(-flat, k, stride=1, padding=radius)
    out = out.reshape(lead + m.shape[-2:])
    return out[..., None] if squeeze else out


def depth_to_mesh(
    depth: torch.Tensor,
    padding: Union[None, float, str] = None,
    fov: float = 45.0,
    modelview: Optional[torch.Tensor] = None,
    atol: Optional[float] = None,
    rtol: Optional[float] = None,
    erode_rgb: Optional[int] = None,
    cal_normal: bool = False,
) -> Mesh:
    """Lift a linearized depth map [s, s, 1] to a world-space grid mesh with flags.

    ``padding``: None, a pixel count (border ring pushed outward in the image
    plane), or ``'frustum'`` (ring pushed out one pixel, then pulled to depth
    0.1 along its ray: a near-plane skirt that keeps novel views conditioned).
    """
    s = depth.shape[0]
    if depth.dim() == 2:
        depth = depth[..., None]
    dev = depth.device
    image_plane_size = 2 * np.tan(0.5 * np.deg2rad(fov))
    points, uv = unproject(depth, fov)
    normal = cal_depth_normal(points) if cal_normal else None
    src_depth = depth

    def edge_pad(x):
        return F.pad(x.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0].permute(1, 2, 0)

    if padding is not None:
        points = edge_pad(points).clone()
        uv = edge_pad(uv)
        depth = edge_pad(depth)
        if cal_normal:
            normal = edge_pad(normal)
        ppp = image_plane_size / s
        if padding != "frustum":
            ppp = padding * ppp
        points[0, :, 1] += ppp * depth[0, :, 0]
        points[-1, :, 1] += -ppp * depth[-1, :, 0]
        points[:, 0, 0] += -ppp * depth[:, 0, 0]
        points[:, -1, 0] += ppp * depth[:, -1, 0]
        if padding == "frustum":
            pull = lambda p: p * rdiv(-0.1, p[..., 2:])
            points[0, :] = pull(points[0, :])
            points[-1, :] = pull(points[-1, :])
            points[:, 0] = pull(points[:, 0])
            points[:, -1] = pull(points[:, -1])
        padding_flag = torch.zeros((s + 2, s + 2), dtype=torch.bool, device=dev)
        padding_flag[0, :] = True
        padding_flag[-1, :] = True
        padding_flag[:, 0] = True
        padding_flag[:, -1] = True
        s_out = s + 2
    else:
        padding_flag = torch.zeros((s, s), dtype=torch.bool, device=dev)
        s_out = s

    faces = triangulate(points)
    positions = points.reshape(-1, 3)
    uv = uv.reshape(-1, 2)
    flat_depth = depth.reshape(-1)
    padding_flag = padding_flag.reshape(-1)
    if cal_normal:
        normal = normal.reshape(-1, 3)

    v = s_out * s_out
    discontinuity_flag = torch.zeros((v,), dtype=torch.bool, device=dev)
    if atol is not None or rtol is not None:
        face_mask = mask_discontinuity(
            faces, flat_depth, atol=atol or 0.0, rtol=rtol or 0.0
        )
        discontinuity_flag[faces[face_mask].reshape(-1)] = True

    if modelview is not None:
        c2w = cam.inverse(modelview)
        positions = cam.transform_points(c2w, positions)
        if cal_normal:
            normal = cam.transform_dirs(c2w, normal)
    else:
        modelview = torch.eye(4, dtype=torch.float32, device=dev)

    erosion_flag = torch.zeros((v,), dtype=torch.bool, device=dev)
    if erode_rgb is not None and erode_rgb > 0:
        keep = (~discontinuity_flag).float().reshape(s_out, s_out)
        keep = erode(keep, erode_rgb)
        erosion_flag = keep.reshape(-1) == 0

    flag = (
        1.0 * discontinuity_flag.float()
        + 2.0 * padding_flag.float()
        + 4.0 * erosion_flag.float()
    )
    return Mesh(
        positions=positions, uv=uv, flag=flag, normal=normal, faces=faces,
        depth=src_depth, modelview=modelview, fov=float(fov),
    )
