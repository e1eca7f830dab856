"""Scene save and load in the reference's compressed npz layout.

``np.savez_compressed(path, data=[{color: png-bytes, depth: png-bytes, fov,
modelview}, ...])``: color is the 8-bit PNG of the view, depth the float32
depth map bit-reinterpreted as an RGBA8 PNG, modelview a [4,4] float32 array.
Port of ``ivid_tpu/inference/scene_io.py``: :func:`save_scene`,
:func:`load_scene` (which rebuilds each view's mesh) and
:func:`load_first_view`. PNGs are read with the port's own decoder
(:func:`ivid_tpu_torch.utils.images.png_decode`), byte-exact for every row
filter, so scenes that an image library wrote load too.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ivid_tpu_torch.ops import geometry as geom
from ivid_tpu_torch.utils.images import png_decode, png_encode


def save_scene(path: str, meshes: List[geom.Mesh], colors: List[np.ndarray]) -> None:
    """``meshes`` with host (numpy or CPU tensor) fields; ``colors`` [s,s,3] in [0,1]."""
    assert len(meshes) == len(colors), f"{len(meshes)} meshes vs {len(colors)} colors"
    data = []
    for mesh, color in zip(meshes, colors):
        color8 = np.clip(np.asarray(color) * 255, 0, 255).astype(np.uint8)
        depth = np.ascontiguousarray(np.asarray(mesh.depth, dtype=np.float32))
        s = depth.shape[0]
        depth_rgba = np.frombuffer(depth.tobytes(), dtype=np.uint8).reshape(s, s, 4)
        data.append({
            "color": png_encode(color8),
            "depth": png_encode(depth_rgba),
            "fov": mesh.fov,
            "modelview": np.asarray(mesh.modelview, dtype=np.float32),
        })
    np.savez_compressed(path, data=np.asarray(data, dtype=object))


def _normalize_modelview(mv) -> np.ndarray:
    """Row-major [4,4] view matrix from whatever the npz stored.

    Reference scenes pickle glm.mat4 objects whose numpy conversion is
    column-major, the transpose of this port's convention. A rigid row-major
    view matrix has the bottom row [0,0,0,1]; its transpose has it in the last
    column instead, so the layout shows in the matrix itself."""
    mv = np.asarray(mv, np.float32)
    e = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    if not np.allclose(mv[3], e, atol=1e-5) and np.allclose(mv[:, 3], e, atol=1e-5):
        return np.ascontiguousarray(mv.T)
    return mv


def _decode_view(record) -> Tuple[np.ndarray, np.ndarray]:
    """A record's color [s,s,3] in [0,1] and its float32 depth [s,s,1]."""
    color = png_decode(record["color"]).astype(np.float32) / 255.0
    s = color.shape[0]
    depth = np.frombuffer(png_decode(record["depth"]).tobytes(), dtype=np.float32)
    return color, depth.reshape(s, s, 1)


def load_scene(path: str, atol: float = 0.03, rtol: float = 0.03, erode_rgb: int = 3,
               device="cuda") -> Tuple[List[geom.Mesh], List[np.ndarray]]:
    """The meshes (rebuilt on ``device`` with ``padding=32`` and normals, as
    the fusion renderer expects) and the [s,s,3] colors of a saved scene."""
    data = np.load(path, allow_pickle=True)["data"]
    meshes, colors = [], []
    for d in data:
        color, depth = _decode_view(d)
        mv = torch.from_numpy(_normalize_modelview(d["modelview"])).to(device)
        meshes.append(geom.depth_to_mesh(
            torch.from_numpy(depth.copy()).to(device), padding=32, fov=float(d["fov"]),
            modelview=mv, atol=atol, rtol=rtol, erode_rgb=erode_rgb, cal_normal=True))
        colors.append(color)
    return meshes, colors


def load_first_view(path: str, near: float = 0.6, far: float = 5.0) -> np.ndarray:
    """The first stored view as an [s,s,4] RGBD image with projected depth."""
    color, depth = _decode_view(np.load(path, allow_pickle=True)["data"][0])
    depth = geom.project_depth(torch.from_numpy(depth.copy()), near, far).numpy()
    return np.concatenate([color, depth], axis=-1)
