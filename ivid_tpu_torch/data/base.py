"""RGBD datasets: normalized RGBD items as NHWC numpy dicts.

Port of ``ivid_tpu/data/base.py``. :class:`BaseDataset` reads an image and
its depth npz per item (``get_file``) and resizes both to ``image_size``
(``process_file``): the image by the native Lanczos-3 resampler
(``data/native.py``), the depth by the nearest-neighbour index rule of PIL,
both with a centre crop. :class:`SRDataset` adds the blurred low-resolution
pair ``y``, and :class:`WarpDataset` the warp hyperparameters (the
forward-backward warp and its augments run on the device inside the train
step, or in loader workers through ``data/warp_host.py``).
:class:`SyntheticRGBD`, :class:`SyntheticRGBDWarp` and
:class:`SyntheticRGBDSR` make procedural items from the item index. Items are
``{"x_0": [H, W, 4] float32}`` plus ``classes`` where labelled, and the SR
items a low-resolution ``y``.

PNG images go through the package's own decoder (``utils/images.png_decode``);
any other format (ImageNet's JPEGs) needs PIL, imported when such a file is
read.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ivid_tpu_torch.data import native
from ivid_tpu_torch.ops.image import gaussian_blur
from ivid_tpu_torch.utils.images import png_decode


def read_image(path: str) -> np.ndarray:
    """The pixels of an image file as uint8 [H, W] or [H, W, C], as
    ``np.asarray(PIL.Image.open(path))`` gives them."""
    if path.lower().endswith(".png"):
        with open(path, "rb") as f:
            return png_decode(f.read())
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {path} needs PIL (Pillow); PNG files are read "
                          "without it") from e
    with Image.open(path) as im:
        return np.asarray(im)


def _crop_geometry(h: int, w: int, size: int):
    """Sides of the image resized so that its shorter side is ``size``, and
    the top-left corner of the centred ``size`` square (torchvision's
    ``Resize(size)`` + ``CenterCrop(size)``)."""
    scale = size / min(w, h)
    nw, nh = max(size, round(w * scale)), max(size, round(h * scale))
    return nh, nw, (nh - size) // 2, (nw - size) // 2


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """PIL's NEAREST source index of each of ``n_out`` outputs: the
    coordinate starts at half a step and adds the step once per output
    pixel in float64 (a running sum, not ``(i + 0.5) * step``), truncated
    and kept inside the input."""
    step = n_in / n_out
    coords = np.add.accumulate(np.concatenate([[step * 0.5], np.full(n_out - 1, step)]))
    return np.minimum(coords.astype(np.int64), n_in - 1)


def nearest_resize_center_crop(depth: np.ndarray, size: int) -> np.ndarray:
    """float32 [H, W] → [size, size]: PIL's ``resize(NEAREST)`` of the
    shorter side to ``size``, then the centred square, equal to PIL's on
    every pixel."""
    h, w = depth.shape
    nh, nw, top, left = _crop_geometry(h, w, size)
    rows = _nearest_index(h, nh)[top:top + size]
    cols = _nearest_index(w, nw)[left:left + size]
    return depth[np.ix_(rows, cols)]


def _pil_lanczos_levels(image: np.ndarray, size: int) -> np.ndarray:
    """The 8-bit levels (as float32) of PIL's ``resize(LANCZOS)`` + centre
    crop. PIL resizes RGBA through premultiplied alpha (RGBa: each colour
    times alpha / 255, rounded; afterwards divided again, truncated), which
    is reproduced here around the native resampler, equal to PIL's on every
    pixel."""
    if image.ndim != 3 or image.shape[-1] != 4:
        return np.round(native.lanczos_resize_center_crop(image, size) * 255)
    alpha = image[..., 3:].astype(np.uint32)
    t = image[..., :3].astype(np.uint32) * alpha + 128
    premultiplied = np.concatenate([((t >> 8) + t) >> 8, alpha], axis=-1).astype(np.uint8)
    out = np.round(native.lanczos_resize_center_crop(premultiplied, size) * 255).astype(np.uint32)
    a = out[..., 3:]
    rgb = np.where((a == 0) | (a == 255), out[..., :3],
                   np.minimum(255 * out[..., :3] // np.maximum(a, 1), 255))
    return np.concatenate([rgb, a], axis=-1).astype(np.float32)


def _rgb(img: np.ndarray) -> np.ndarray:
    """[s, s, C] → [s, s, 3]: gray repeated, alpha dropped."""
    if img.shape[-1] == 1:
        return np.concatenate([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        return img[..., :3]
    return img


class BaseDataset:
    """Items read from files under ``root_path``: ``images`` and ``depths``
    (paths relative to it) and ``labels`` (class name → id, or None), listed
    by ``get_fileinfo``. ``prepocess_depth`` (the reference's spelling, kept
    for its configs): none | to_depth | disparity_minmax | depth_minmax |
    z_buffer."""

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

    def __len__(self):
        return len(self.images)

    def get_file(self, index: int):
        """(image uint8 [H, W(, C)], depth float32 [H, W], label or None).
        The stored disparity (``arr_0``) is divided by 6250, scaled down to
        at most ``1/near``, floored at 1e-3, then preprocessed."""
        image = read_image(os.path.join(self.root_path, self.images[index]))
        depth = np.load(os.path.join(self.root_path, self.depths[index]))["arr_0"].astype(
            np.float32)
        depth /= 6250
        if depth.max() > 1 / self.near:
            depth /= depth.max() * self.near
        depth = np.maximum(depth, 1e-3)
        if self.prepocess_depth == "to_depth":
            depth = 1 / depth
        elif self.prepocess_depth == "disparity_minmax":
            depth = (depth - depth.min()) / (depth.max() - depth.min())
        elif self.prepocess_depth == "depth_minmax":
            depth = 1 / depth
            depth = (depth - depth.min()) / (depth.max() - depth.min())
        elif self.prepocess_depth == "z_buffer":
            depth = (depth - 1 / self.near) / (1 / self.far - 1 / self.near)
            depth = np.clip(depth, 0, 1)
        label = (self.labels[self.images[index].split("/")[-2]]
                 if self.num_classes is not None else None)
        return image, depth, label

    def process_file(self, image, depth, label) -> dict:
        """The item at ``image_size``: Lanczos RGB and nearest depth, both
        centre-cropped, normalized to [-1, 1] where asked."""
        img = _rgb(native.lanczos_resize_center_crop(image, self.image_size))
        if self.normalize:
            img = img * 2 - 1
        d = nearest_resize_center_crop(depth, self.image_size)[..., None]
        if self.normalize_depth:
            d = d * 2 - 1
        data = {"x_0": np.concatenate([img, d], axis=-1)}
        if label is not None:
            data["classes"] = np.int32(label)
        return data

    def getitem(self, index: int) -> dict:
        return self.process_file(*self.get_file(index))

    def __getitem__(self, index: int) -> dict:
        """The item, or, where loading it raises, the item at a random index
        (``np.random``), up to 100 tries."""
        for _ in range(100):
            try:
                return self.getitem(index)
            except Exception as e:  # noqa: BLE001 - a damaged file must not stop training
                print(f"dataset error at {index}: {e!r}")
                index = np.random.randint(len(self))
        raise RuntimeError("dataset failed 100 consecutive loads")


class SRDataset(BaseDataset):
    """Items with ``y``: the image at ``image_size_lr`` (Lanczos with centre
    crop, as PIL resizes it: the JAX package takes ``y`` from PIL and
    ``x_0`` from the native resampler, which differ on RGBA images),
    blurred on its 0-255 levels by a 3x3 Gaussian of sigma
    ``np.random.rand() + 1e-3`` with cv2's reflect-101 border, and the
    nearest depth at that size."""

    def __init__(self, root_path, image_size, image_size_lr, **kwargs):
        super().__init__(root_path, image_size, **kwargs)
        self.image_size_lr = image_size_lr

    def process_file(self, image, depth, label) -> dict:
        data = super().process_file(image, depth, label)
        levels = _pil_lanczos_levels(image, self.image_size_lr)
        sigma = np.random.rand() + 1e-3
        img = gaussian_blur(torch.from_numpy(levels), sigma, border="reflect").numpy()
        img = _rgb(img / 255.0)
        if self.normalize:
            img = img * 2 - 1
        d = nearest_resize_center_crop(depth, self.image_size_lr)[..., None]
        if self.normalize_depth:
            d = d * 2 - 1
        data["y"] = np.concatenate([img, d], axis=-1).astype(np.float32)
        return data


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
