"""Host-side image utilities: PNG encoding, grid montages, depth images,
int-list parsing. Port of ``ivid_tpu/utils/images.py`` in numpy and the
standard library alone (PNGs are written with ``zlib`` + ``struct``, so no
image library is needed)."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def parse_int_list(s: str):
    """Parse "0-8,12" style ranges."""
    out = []
    for part in s.split(","):
        if "-" in part:
            start, end = part.split("-")
            out += list(range(int(start), int(end) + 1))
        else:
            out.append(int(part))
    return out


def to8b(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def png_encode(arr: np.ndarray) -> bytes:
    """8-bit PNG bytes of a uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4]
    (RGBA) array."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def colorize_depth(depth: np.ndarray, vmin=-1.0, vmax=1.0) -> np.ndarray:
    """Inverted depth as a gray 3-channel image in [vmin, vmax]. Input
    [..., H, W] or [..., H, W, 1]; output [..., H, W, 3]. The JAX package maps
    the same values through cv2's INFERNO colormap; that colormap is not
    ported, so this shows them in gray."""
    d = np.asarray(depth, np.float32)
    if d.shape[-1] == 1:
        d = d[..., 0]
    d = np.clip(1 - (d - vmin) / (vmax - vmin), 0, 1)
    out = np.repeat(d[..., None], 3, axis=-1)
    return out * (vmax - vmin) + vmin


def make_grid(images: np.ndarray, nrow: int = 8, normalize: bool = False,
              value_range=(-1.0, 1.0), pad: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """Tile [N,H,W,C] into a torchvision-style grid montage [GH,GW,C]."""
    imgs = np.asarray(images, dtype=np.float32)
    if normalize:
        lo, hi = value_range
        imgs = np.clip((imgs - lo) / max(hi - lo, 1e-12), 0, 1)
    n, h, w, c = imgs.shape
    ncol = nrow
    nrow_out = int(np.ceil(n / ncol))
    grid = np.full((nrow_out * (h + pad) + pad, ncol * (w + pad) + pad, c), pad_value, np.float32)
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = imgs[idx]
    return grid


def save_image(path: str, image: np.ndarray) -> None:
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_encode(to8b(image)))


def save_image_grid(path: str, images: np.ndarray, nrow: int = 8, normalize: bool = True,
                    value_range=(-1.0, 1.0)) -> None:
    save_image(path, make_grid(images, nrow, normalize, value_range))
