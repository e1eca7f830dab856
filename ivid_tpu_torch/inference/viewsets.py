"""Viewset construction and grid-reorder permutation for multiview sampling.

A numpy copy of ``ivid_tpu/inference/viewsets.py`` (the port imports nothing
of the JAX package). Mirrors the reference camera viewsets (reference: inference/sample.py:304-338):
``uncond`` (single canonical view), ``random`` (canonical + one sampled orbit),
``3x9`` (27-view yaw×pitch grid in center-out generation order), and the 3x9
sampling-order → display-grid permutation (reference: inference/utils.py:44-55),
and the free-view render's camera paths (:func:`swing_trajectory`,
:func:`random_trajectory`; reference: inference/render.py:42-60).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _look_at(eye, center, up) -> np.ndarray:
    """Right-handed view matrix, glm.lookAt-compatible (host numpy)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.stack([
        np.concatenate([s, [-np.dot(s, eye)]]),
        np.concatenate([u, [-np.dot(u, eye)]]),
        np.concatenate([-f, [np.dot(f, eye)]]),
        np.array([0.0, 0.0, 0.0, 1.0], np.float32),
    ]).astype(np.float32)
    return m


def _orbit(yaw: float, pitch: float, radius: float = 1.0) -> np.ndarray:
    eye = np.array([
        radius * np.sin(yaw) * np.cos(pitch),
        radius * np.sin(pitch),
        radius * np.cos(yaw) * np.cos(pitch),
    ], np.float32)
    return _look_at(eye, np.zeros(3), np.array([0.0, 1.0, 0.0]))


def canonical_view() -> np.ndarray:
    return _look_at([0, 0, 1], [0, 0, 0], [0, 1, 0])


def build_viewset(
    name: str, num_samples: int, rng: Optional[np.random.Generator] = None
):
    """Return modelviews: a shared list (uncond/3x9) or one list per sample
    (random), matching the reference structure (sample.py:304-338)."""
    if name == "uncond":
        return [canonical_view()]
    if name == "random":
        rng = rng or np.random.default_rng()
        views = []
        for _ in range(num_samples):
            yaw = 0.3 * rng.standard_normal()
            pitch = 0.15 * rng.standard_normal()
            views.append([canonical_view(), _orbit(yaw, pitch)])
        return views
    if name == "3x9":
        yaws = [0.0]
        pitches = [0.0]
        for i in range(4):
            yaws += [(i + 1) * 0.15, -(i + 1) * 0.15]
        for i in range(1):
            pitches += [(i + 1) * 0.15, -(i + 1) * 0.15]
        return [_orbit(yaw, pitch) for yaw in yaws for pitch in pitches]
    raise ValueError(f"unknown viewset {name!r}")


# Sampling order → 3x9 display grid (reference: inference/utils.py:48-51).
REORDER_3X9 = [
    23, 17, 11, 5, 2, 8, 14, 20, 26,
    21, 15, 9, 3, 0, 6, 12, 18, 24,
    22, 16, 10, 4, 1, 7, 13, 19, 25,
]


def reorder(images: np.ndarray, order: str = "3x9") -> np.ndarray:
    """Permute a stack of view images from sampling order into the 3x9 display
    grid; a 26-view stack gets a placeholder first view
    (reference: inference/utils.py:44-55)."""
    if order != "3x9":
        raise NotImplementedError(order)
    data = list(np.asarray(images))
    if len(data) == 26:
        data.insert(0, -np.ones_like(data[0]))
    return np.stack([data[i] for i in REORDER_3X9], axis=0)


def swing_trajectory(frames: int = 60) -> List[np.ndarray]:
    """``frames`` poses of an orbit sweep (reference: inference/render.py:42-49)."""
    ts = np.linspace(0, 2 * np.pi, frames)
    return [_orbit(0.6 * np.cos(t), 0.15 * np.sin(t)) for t in ts]


def random_trajectory(rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """One clipped random pose (reference: inference/render.py:50-60)."""
    rng = rng or np.random.default_rng()
    yaw = float(np.clip(0.3 * rng.standard_normal(), -0.6, 0.6))
    pitch = float(np.clip(0.15 * rng.standard_normal(), -0.15, 0.15))
    return _orbit(yaw, pitch)
