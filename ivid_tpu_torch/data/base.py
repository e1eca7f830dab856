"""RGBD datasets: normalized RGBD items as NHWC numpy dicts.

Port of ``ivid_tpu/data/base.py``'s dataset classes that need no files:
:class:`BaseDataset` holds the normalization fields, :class:`WarpDataset`
the warp hyperparameters (the forward-backward warp and its augments run on
the device inside the train step), and :class:`SyntheticRGBD`,
:class:`SyntheticRGBDWarp` and :class:`SyntheticRGBDSR` make procedural items
from the item index. Items are ``{"x_0": [H, W, 4] float32}`` plus
``classes`` where labelled, and the SR items a low-resolution ``y``.
"""

from __future__ import annotations

from typing import List

import numpy as np


class BaseDataset:
    """Normalization fields shared by every dataset. ``prepocess_depth``
    (the reference's spelling, kept for its configs): none | to_depth |
    disparity_minmax | depth_minmax | z_buffer."""

    def __init__(self, root_path: str, image_size: int, normalize: bool = False,
                 normalize_depth: bool = False, prepocess_depth: str = "none",
                 near: float = 0.5, far: float = 100.0):
        if prepocess_depth not in ("none", "to_depth", "disparity_minmax", "depth_minmax",
                                   "z_buffer"):
            raise ValueError(f"unknown prepocess_depth {prepocess_depth!r}")
        if normalize_depth and prepocess_depth in ("none", "to_depth"):
            raise ValueError(f"normalize_depth needs a bounded depth, not {prepocess_depth!r}")
        self.root_path = root_path
        self.image_size = image_size
        self.normalize = normalize
        self.normalize_depth = normalize_depth
        self.prepocess_depth = prepocess_depth
        self.near = near
        self.far = far
        self.images: List[str] = []
        self.depths: List[str] = []
        self.labels = None
        self.get_fileinfo()
        self.num_classes = len(self.labels) if self.labels is not None else None

    def get_fileinfo(self):
        raise NotImplementedError

    def getitem(self, index: int) -> dict:
        raise NotImplementedError

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int) -> dict:
        return self.getitem(index)


class WarpDataset(BaseDataset):
    """Clean RGBD items plus the warp hyperparameters: ``augments`` (any of
    prewarp_noise, postwarp_noise, blur, erode_rgb) and the pose std."""

    def __init__(self, root_path, image_size, augments=(), std=0.15, **kwargs):
        super().__init__(root_path, image_size, **kwargs)
        self.augments = list(augments)
        self.std = std


class SyntheticRGBD(BaseDataset):
    """Procedural RGBD items (no files): three smooth random blobs over a
    background plane, drawn from ``np.random.default_rng(index)``."""

    def __init__(self, root_path="", image_size=128, length=256, num_classes=None, **kwargs):
        self._length = length
        self._num_classes_cfg = num_classes
        super().__init__(root_path, image_size, **kwargs)

    def get_fileinfo(self):
        self.images = [str(i) for i in range(self._length)]
        self.depths = self.images
        self.labels = ({str(i): i for i in range(self._num_classes_cfg)}
                       if self._num_classes_cfg else None)

    def getitem(self, index: int) -> dict:
        s = self.image_size
        rng = np.random.default_rng(index)
        i, j = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
        img = np.zeros((s, s, 3), np.float32)
        disp = np.full((s, s), 1.0, np.float32)
        for _ in range(3):
            cx, cy = rng.uniform(0.2 * s, 0.8 * s, 2)
            r = rng.uniform(0.1 * s, 0.3 * s)
            blob = np.exp(-(((i - cx) ** 2 + (j - cy) ** 2) / r ** 2))
            img += blob[..., None] * rng.uniform(0.2, 1.0, 3)
            disp += blob * rng.uniform(0.2, 0.8)
        img = np.clip(img, 0, 1)
        depth = 1.0 / disp
        stored = (1 / depth - 1 / self.near) / (1 / self.far - 1 / self.near)
        stored = np.clip(stored, 0, 1).astype(np.float32)
        if self.normalize:
            img = img * 2 - 1
        d = stored[..., None]
        if self.normalize_depth:
            d = d * 2 - 1
        data = {"x_0": np.concatenate([img, d], axis=-1).astype(np.float32)}
        if self.num_classes:
            data["classes"] = np.int32(index % self.num_classes)
        return data


class SyntheticRGBDWarp(SyntheticRGBD, WarpDataset):
    def __init__(self, root_path="", image_size=128, length=256, num_classes=None,
                 augments=(), std=0.15, **kwargs):
        SyntheticRGBD.__init__(self, root_path, image_size, length, num_classes, **kwargs)
        self.augments = list(augments)
        self.std = std


class SyntheticRGBDSR(SyntheticRGBD):
    """The procedural items at ``image_size`` with ``y``, the same item
    subsampled by the stride ``image_size // image_size_lr``."""

    def __init__(self, root_path="", image_size=256, image_size_lr=128, length=256,
                 num_classes=None, **kwargs):
        self.image_size_lr = image_size_lr
        SyntheticRGBD.__init__(self, root_path, image_size, length, num_classes, **kwargs)

    def getitem(self, index: int) -> dict:
        data = SyntheticRGBD.getitem(self, index)
        stride = self.image_size // self.image_size_lr
        data["y"] = np.ascontiguousarray(data["x_0"][::stride, ::stride])
        return data
