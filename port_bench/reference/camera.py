"""Camera math: perspective projections and homogeneous transforms.

Plain 4x4 matrices in standard math convention, ``clip = P @ MV @ [x, y, z, 1]``,
with OpenGL's conventions (right-handed eye space looking down ``-z``, NDC z in
[-1, 1]) so depth-buffer semantics match the reference GL pipeline. Float32
throughout; matrix products run in full f32 (no TF32).

A frozen copy of ``ivid_tpu_torch/ops/camera.py`` (its plain versions only).
"""

from __future__ import annotations

import numpy as np
import torch


def look_at(eye: torch.Tensor, center: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Right-handed view matrices [..., 4, 4] (glm.lookAt) from ``eye``,
    ``center`` and ``up`` [..., 3] (broadcast)."""
    eye, center, up = torch.broadcast_tensors(eye.float(), center.float(), up.float())
    f = center - eye
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    s = torch.linalg.cross(f, up, dim=-1)
    s = s / torch.linalg.vector_norm(s, dim=-1, keepdim=True)
    u = torch.linalg.cross(s, f, dim=-1)
    dot = lambda a, b: (a * b).sum(dim=-1, keepdim=True)
    last = torch.zeros(eye.shape[:-1] + (4,), dtype=eye.dtype, device=eye.device)
    last[..., 3] = 1.0
    return torch.stack([
        torch.cat([s, -dot(s, eye)], dim=-1),
        torch.cat([u, -dot(u, eye)], dim=-1),
        torch.cat([-f, dot(f, eye)], dim=-1),
        last,
    ], dim=-2)


def perspective(fov_y_deg: float, aspect: float, near: float, far: float,
                device=None) -> torch.Tensor:
    """Right-handed perspective projection, NDC z in [-1, 1] (glm.perspective)."""
    t = 1.0 / np.tan(np.deg2rad(fov_y_deg) / 2.0)
    m = np.array([
        [t / aspect, 0, 0, 0],
        [0, t, 0, 0],
        [0, 0, -(far + near) / (far - near), -2.0 * far * near / (far - near)],
        [0, 0, -1.0, 0],
    ], np.float32)
    return torch.from_numpy(m).to(device)


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 homogeneous transform to [..., 3] points (affine, w dropped)."""
    return torch.matmul(pts, m[:3, :3].T) + m[:3, 3]


def transform_dirs(m: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Rotate direction vectors by the upper 3x3 of a 4x4 transform."""
    return torch.matmul(dirs, m[:3, :3].T)


def inverse(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(m)


def camera_position(modelview: torch.Tensor) -> torch.Tensor:
    """World-space camera position(s) from view matrices [..., 4, 4]."""
    return inverse(modelview)[..., :3, 3]
