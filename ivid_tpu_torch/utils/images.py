"""Host-side image utilities: PNG encoding and decoding, grid montages, depth
images, int-list parsing. Port of ``ivid_tpu/utils/images.py`` in numpy and
the standard library alone (PNGs are written and read with ``zlib`` +
``struct``, so no image library is needed)."""

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


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Samples per pixel of the 8-bit colour types: gray, RGB, gray + alpha, RGBA.
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def png_encode(arr: np.ndarray) -> bytes:
    """8-bit PNG bytes of a uint8 [H, W] (gray), [H, W, 2] (gray + alpha),
    [H, W, 3] (RGB) or [H, W, 4] (RGBA) array, every row unfiltered."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {n: t for t, n in _PNG_CHANNELS.items()}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def _unfilter_serial(kind: int, raw: bytes, prior: bytes, bpp: int) -> bytearray:
    """Undo the Average (3) or Paeth (4) filter of one row. Both predict a
    byte from the byte ``bpp`` to its left after it was decoded, so the row
    is decoded in order."""
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def png_decode(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit, non-interlaced PNG as uint8: [H, W] (gray),
    [H, W, 2] (gray + alpha), [H, W, 3] (RGB) or [H, W, 4] (RGBA), as
    ``imageio.imread`` returns them. Every row filter (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth) is undone byte-exactly, so a float32 map stored as
    RGBA8 comes back bit-equal. Palette images, other bit depths, interlaced
    images and damaged chunks raise ``ValueError``."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r} is truncated or fails its CRC")
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _PNG_CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color_type} "
                         "(8-bit gray, gray + alpha, RGB and RGBA are read)")
    if interlace:
        raise ValueError("interlaced PNGs are not read")
    c = _PNG_CHANNELS[color_type]
    stride = w * c
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, not {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            # Sub adds the decoded byte to the left: a running sum per channel.
            out[y] = (np.cumsum(line.reshape(w, c), axis=0, dtype=np.int64) & 0xFF).reshape(-1)
        elif kind == 2:
            out[y] = line + prior
        elif kind in (3, 4):
            out[y] = np.frombuffer(_unfilter_serial(kind, line.tobytes(), prior.tobytes(), c),
                                   np.uint8)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {kind}")
        prior = out[y]
    img = out.reshape(h, w, c)
    return img[..., 0] if c == 1 else img


# cv2's COLORMAP_INFERNO as 256 RGB rows of uint8 (cv2.applyColorMap of
# 0..255, converted BGR to RGB), transcribed once: the card's machine has no
# cv2, and the depth images must be the JAX package's.
INFERNO = np.frombuffer(bytes.fromhex(
    "00000401000501010601010802010a02020c02020e03021004031204031405041706041907051b08051d09061f0a0722"
    "0b07240c08260d08290e092b10092d110a30120a32140b34150b37160b39180c3c190c3e1b0c411c0c431e0c451f0c48"
    "210c4a230c4c240c4f260c51280b53290b552b0b572d0b592f0a5b310a5c320a5e340a5f3609613809623909633b0964"
    "3d09653e0966400a67420a68440a68450a69470b6a490b6a4a0c6b4c0c6b4d0d6c4f0d6c510e6c520e6d540f6d550f6d"
    "57106e59106e5a116e5c126e5d126e5f136e61136e62146e64156e65156e67166e69166e6a176e6c186e6d186e6f196e"
    "71196e721a6e741a6e751b6e771c6d781c6d7a1d6d7c1d6d7d1e6d7f1e6c801f6c82206c84206b85216b87216b88226a"
    "8a226a8c23698d23698f24699025689225689326679526679727669827669a28659b29649d29649f2a63a02a63a22b62"
    "a32c61a52c60a62d60a82e5fa92e5eab2f5ead305dae305cb0315bb1325ab3325ab43359b63458b73557b93556ba3655"
    "bc3754bd3853bf3952c03a51c13a50c33b4fc43c4ec63d4dc73e4cc83f4bca404acb4149cc4248ce4347cf4446d04545"
    "d24644d34743d44842d54a41d74b3fd84c3ed94d3dda4e3cdb503bdd513ade5238df5337e05536e15635e25734e35933"
    "e45a31e55c30e65d2fe75e2ee8602de9612bea632aeb6429eb6628ec6726ed6925ee6a24ef6c23ef6e21f06f20f1711f"
    "f1731df2741cf3761bf37819f47918f57b17f57d15f67e14f68013f78212f78410f8850ff8870ef8890cf98b0bf98c0a"
    "f98e09fa9008fa9207fa9407fb9606fb9706fb9906fb9b06fb9d07fc9f07fca108fca309fca50afca60cfca80dfcaa0f"
    "fcac11fcae12fcb014fcb216fcb418fbb61afbb81dfbba1ffbbc21fbbe23fac026fac228fac42afac62df9c72ff9c932"
    "f9cb35f8cd37f8cf3af7d13df7d340f6d543f6d746f5d949f5db4cf4dd4ff4df53f4e156f3e35af3e55df2e661f2e865"
    "f2ea69f1ec6df1ed71f1ef75f1f179f2f27df2f482f3f586f3f68af4f88ef5f992f6fa96f8fb9af9fc9dfafda1fcffa4"
), dtype=np.uint8).reshape(256, 3)


def colorize_depth(depth: np.ndarray, vmin=-1.0, vmax=1.0) -> np.ndarray:
    """INFERNO-colormapped inverted depth, as the JAX package's
    ``colorize_depth``: ``1 - (d - vmin) / (vmax - vmin)`` clipped to [0, 1],
    cut to 8 bits, looked up in :data:`INFERNO`, and mapped back to
    [vmin, vmax]. Input [..., H, W] or [..., H, W, 1]; output [..., H, W, 3]."""
    d = np.asarray(depth)
    if d.shape[-1] == 1:
        d = d[..., 0]
    d = np.clip(1 - (d - vmin) / (vmax - vmin), 0, 1)
    out = INFERNO[(d * 255).astype(np.uint8)].astype(np.float32) / 255.0
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
