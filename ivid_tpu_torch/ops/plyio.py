"""Binary PLY export for colored meshes (reference: rgbd_3d/utils.py:14-31).

A copy of ``ivid_tpu/ops/plyio.py`` (the port imports nothing of the JAX
package); it writes the same bytes. Little-endian ``binary_1.0``: float xyz
and uchar rgb per vertex, a uchar count and three int indices per face."""

from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def save_ply(path: str, positions, colors, faces) -> None:
    """``positions`` [V,3] float, ``colors`` [V,3] float in [0,1], ``faces``
    [F,3] int; numpy arrays or tensors."""
    positions = _host(positions).astype(np.float32)
    colors8 = np.clip(_host(colors) * 255, 0, 255).astype(np.uint8)
    faces = _host(faces).astype(np.int32)
    v, f = len(positions), len(faces)
    header = "\n".join([
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {v}",
        "property float x",
        "property float y",
        "property float z",
        "property uchar red",
        "property uchar green",
        "property uchar blue",
        f"element face {f}",
        "property list uchar int vertex_indices",
        "end_header",
        "",
    ])
    verts = np.empty(v, np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]))
    verts["xyz"] = positions
    verts["rgb"] = colors8
    fdata = np.empty(f, np.dtype([("n", "u1"), ("idx", "<i4", 3)]))
    fdata["n"] = 3
    fdata["idx"] = faces
    with open(path, "wb") as fp:
        fp.write(header.encode("ascii"))
        fp.write(verts.tobytes())
        fp.write(fdata.tobytes())


def mesh_to_ply(path: str, mesh, color_image) -> None:
    """Export a :class:`ivid_tpu_torch.ops.geometry.Mesh` with its texture
    baked to vertex colors (nearest lookup, like the GL pipeline's
    texturing)."""
    uv = _host(mesh.uv)
    img = _host(color_image)
    s = img.shape[0]
    j = np.clip((uv[:, 0] * s).astype(int), 0, s - 1)
    i = np.clip((uv[:, 1] * s).astype(int), 0, s - 1)
    save_ply(path, _host(mesh.positions), img[i, j], _host(mesh.faces))
