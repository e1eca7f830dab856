"""The inputs a run hands the program, made from the run's seed.

- Cameras: fixed or drawn orbit views (:func:`views`), such as the
  product's ``random`` viewset (the canonical view and one orbit per scene).
- Class labels, uniform over the model's classes.
- Procedural RGBD training images: three smooth random blobs over a
  background plane, as the port's ``SyntheticRGBD`` makes them. The set of
  images is the same for every seed (item ``i`` from ``i`` alone); the seed
  orders them, through the trainer's loader, and draws the warps.

Every batch is drawn from the seed and its own index, so every seed gives
the same sizes in another arrangement.
"""

from __future__ import annotations

import numpy as np


def host_rng(seed: int, *path) -> np.random.Generator:
    """A numpy generator of ``seed`` (any whole number) and ``path`` (whole
    numbers naming the draw)."""
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), *[int(p) for p in path]])


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed view matrix (glm.lookAt)."""
    eye, center, up = (np.asarray(v, np.float32) for v in (eye, center, up))
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    return np.stack([
        np.concatenate([s, [-np.dot(s, eye)]]),
        np.concatenate([u, [-np.dot(u, eye)]]),
        np.concatenate([-f, [np.dot(f, eye)]]),
        np.array([0.0, 0.0, 0.0, 1.0], np.float32),
    ]).astype(np.float32)


def orbit(yaw: float, pitch: float, radius: float = 1.0) -> np.ndarray:
    eye = np.array([radius * np.sin(yaw) * np.cos(pitch), radius * np.sin(pitch),
                    radius * np.cos(yaw) * np.cos(pitch)], np.float32)
    return look_at(eye, np.zeros(3), np.array([0.0, 1.0, 0.0]))


def views(rng: np.random.Generator, batch: int, spec) -> np.ndarray:
    """[batch, V, 4, 4] cameras on the unit orbit around the origin, one per
    entry of ``spec``: ``{"yaw": a, "pitch": b}`` (radians) for a fixed view,
    ``{"yaw_std": s, "pitch_std": t}`` for one drawn per scene, yaw N(0, s²)
    then pitch N(0, t²). The ``random`` viewset of the product's ``sample``
    CLI is ``[{"yaw": 0, "pitch": 0}, {"yaw_std": 0.3, "pitch_std": 0.15}]``;
    a fixed grid such as ``3x9`` lists its views."""
    out = []
    for _ in range(batch):
        scene = []
        for v in spec:
            if "yaw_std" in v:
                yaw = v["yaw_std"] * rng.standard_normal()
                pitch = v["pitch_std"] * rng.standard_normal()
            else:
                yaw, pitch = v["yaw"], v["pitch"]
            scene.append(orbit(yaw, pitch))
        out.append(scene)
    return np.asarray(out, np.float32)


def classes(rng: np.random.Generator, batch: int, num_classes) -> np.ndarray:
    """[batch] labels uniform over ``num_classes``, or None for a model
    without classes."""
    if not num_classes:
        return None
    return rng.integers(0, int(num_classes), size=batch).astype(np.int64)


class SyntheticRGBD:
    """Procedural RGBD items ``{"x_0": [s, s, 4]}`` in [-1, 1] (depth stored
    as z-buffer disparity between ``near`` and ``far``), made in set-up, with
    the attributes the inpaint trainer reads (``augments``, ``std``,
    ``near``, ``far``).
    Item ``i`` comes from ``i`` alone, so that every seed trains on the same
    images (a run's work does not depend on its seed)."""

    def __init__(self, length: int, image_size: int, blobs: int, near: float,
                 far: float, augments, std: float):
        self.length = int(length)
        self.image_size = int(image_size)
        self.blobs = int(blobs)
        self.near, self.far = float(near), float(far)
        self.augments = list(augments)
        self.std = float(std)
        # Made once, so the loader's workers only hand them out.
        self.items = [self._make(i) for i in range(self.length)]

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> dict:
        return {"x_0": self.items[index]}

    def _make(self, index: int) -> np.ndarray:
        s = self.image_size
        rng = host_rng(7, index)
        i, j = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
        img = np.zeros((s, s, 3), np.float32)
        disp = np.full((s, s), 1.0, np.float32)
        for _ in range(self.blobs):
            cx, cy = rng.uniform(0.2 * s, 0.8 * s, 2)
            r = rng.uniform(0.1 * s, 0.3 * s)
            blob = np.exp(-(((i - cx) ** 2 + (j - cy) ** 2) / r ** 2))
            img += blob[..., None] * rng.uniform(0.2, 1.0, 3)
            disp += blob * rng.uniform(0.2, 0.8)
        img = np.clip(img, 0, 1)
        depth = 1.0 / disp
        stored = np.clip((1 / depth - 1 / self.near) / (1 / self.far - 1 / self.near), 0, 1)
        x = np.concatenate([img * 2 - 1, stored[..., None] * 2 - 1], axis=-1)
        return x.astype(np.float32)
