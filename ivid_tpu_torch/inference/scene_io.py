"""Scene save in the reference's compressed npz layout.

``np.savez_compressed(path, data=[{color: png-bytes, depth: png-bytes, fov,
modelview}, ...])``: color is the 8-bit PNG of the view, depth the float32
depth map bit-reinterpreted as an RGBA8 PNG, modelview a [4,4] float32 array.
Port of ``ivid_tpu/inference/scene_io.py:save_scene``."""

from __future__ import annotations

from typing import List

import numpy as np

from ivid_tpu_torch.ops import geometry as geom
from ivid_tpu_torch.utils.images import png_encode


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
