"""The port's PNG decoder and scene loading vs imageio and the JAX package (CPU).

- ``png_decode`` against ``imageio.imread`` of the same bytes, exactly: PNGs
  written here with each row filter (0 None, 1 Sub, 2 Up, 3 Average,
  4 Paeth, and all five in turn) for gray, gray + alpha, RGB and RGBA; PNGs
  that PIL wrote (it picks a filter per row); and the depth layout, float32
  bits as RGBA8, bit-equal with NaN payloads, infinities, -0 and subnormals.
  What it does not read (16-bit, palette, interlaced, a bad CRC) raises.
- ``load_scene``/``load_first_view`` on a scene that the JAX ``save_scene``
  wrote: colors and depth exactly; the rebuilt meshes within 1e-6 (the JAX
  loader builds them under ``jit``, which may contract a multiply-add).
"""

import io
import struct
import zlib

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ivid_tpu.inference import scene_io as jscene
from ivid_tpu.ops import camera as jcam
from ivid_tpu.ops import geometry as jgeom
from ivid_tpu_torch.inference import scene_io
from ivid_tpu_torch.utils.images import png_decode, png_encode

torch.set_num_threads(2)

COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(
        ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_filtered(arr, filters, interlace=0, idat_parts=3):
    """An 8-bit PNG of ``arr`` whose row y uses filter
    ``filters[y % len(filters)]``, its data split over several IDAT chunks."""
    a = arr if arr.ndim == 3 else arr[..., None]
    h, w, c = a.shape
    rows = a.reshape(h, w * c).astype(np.int64)
    zero = np.zeros(c, np.int64)
    prior = np.zeros(w * c, np.int64)
    raw = bytearray()
    for y in range(h):
        f, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([zero, cur[:-c]])
        upleft = np.concatenate([zero, prior[:-c]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        raw.append(f)
        raw += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = cur
    z = zlib.compress(bytes(raw))
    cut = np.linspace(0, len(z), idat_parts + 1).astype(int)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPE[c], 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + b"".join(_chunk(b"IDAT", z[a:b]) for a, b in zip(cut, cut[1:]))
            + _chunk(b"IEND", b""))


def _image(shape, seed):
    """Noise on a gradient, so every filter's predictions wrap around 256."""
    rng = np.random.default_rng(seed)
    grad = np.linspace(0, 400, int(np.prod(shape))).reshape(shape)
    return ((grad + rng.integers(0, 60, shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_png_decode_every_filter_matches_imageio(channels, filters):
    shape = (11, 13) if channels == 1 else (11, 13, channels)
    arr = _image(shape, channels)
    data = encode_filtered(arr, filters)
    got = png_decode(data)
    want = np.asarray(imageio.imread(io.BytesIO(data)))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("shape", [(40, 33), (40, 33, 3), (40, 33, 4)], ids=["L", "RGB", "RGBA"])
def test_png_decode_reads_what_pil_writes(shape):
    """PIL chooses a filter for each row (and ``save_scene`` in the JAX
    package writes through it); ``png_encode`` writes filter 0."""
    for arr in (_image(shape, 7), np.random.default_rng(8).integers(0, 256, shape, np.uint8)):
        f = io.BytesIO()
        Image.fromarray(arr).save(f, format="png")
        data = f.getvalue()
        np.testing.assert_array_equal(png_decode(data), np.asarray(imageio.imread(io.BytesIO(data))))
        np.testing.assert_array_equal(png_decode(png_encode(arr)), arr)


def test_png_decode_depth_bits_exact():
    """A float32 map stored as RGBA8 comes back bit for bit: quiet and
    signalling NaNs with payloads, infinities, -0, subnormals, extremes."""
    rng = np.random.default_rng(3)
    bits = rng.uniform(0.3, 7.0, (24, 24)).astype(np.float32).view(np.uint32)
    specials = [0x7FC00000, 0x7FC12345, 0xFFC00001, 0x7F800001, 0x7FBFFFFF, 0x7F800000,
                0xFF800000, 0x80000000, 0x00000001, 0x807FFFFF, 0x7F7FFFFF, 0x00800000]
    bits.reshape(-1)[::37][:len(specials)] = specials
    depth = bits.view(np.float32)
    rgba = np.frombuffer(depth.tobytes(), np.uint8).reshape(24, 24, 4)
    for data in (jscene._png_encode(rgba), png_encode(rgba),
                 encode_filtered(rgba, [4, 3, 1, 2, 0])):
        back = np.frombuffer(png_decode(data).tobytes(), np.float32).reshape(24, 24)
        np.testing.assert_array_equal(back.view(np.uint32), bits)


def _pil_bytes(img):
    f = io.BytesIO()
    img.save(f, format="png")
    return f.getvalue()


@pytest.mark.parametrize("case", ["16bit", "palette", "interlaced", "bad_crc", "not_png"])
def test_png_decode_rejects_what_it_cannot_read(case):
    arr = _image((6, 5, 3), 1)
    if case == "16bit":
        data, match = _pil_bytes(Image.fromarray(np.arange(30, dtype=np.uint16).reshape(6, 5) * 999)), "bit depth 16"
    elif case == "palette":
        data, match = _pil_bytes(Image.fromarray(arr).convert("P")), "colour type 3"
    elif case == "interlaced":
        data, match = encode_filtered(arr, [0], interlace=1), "interlaced"
    elif case == "bad_crc":
        good = encode_filtered(arr, [1])
        data, match = good[:40] + bytes([good[40] ^ 1]) + good[41:], "CRC"
    else:
        data, match = b"GIF89a" + bytes(30), "not a PNG"
    with pytest.raises(ValueError, match=match):
        png_decode(data)


def _jax_scene(path, s=16):
    """Two views saved by the JAX ``save_scene``; the second record's
    modelview then stored column-major, as reference scenes pickle it."""
    rng = np.random.default_rng(0)
    meshes, colors = [], []
    for eye in ([0.0, 0.0, 1.0], [0.4, 0.2, 1.0]):
        mv = jcam.look_at(jnp.array(eye), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
        rgbd = rng.uniform(0.2, 0.8, size=(s, s, 4)).astype(np.float32)
        meshes.append(jgeom.depth_to_mesh(
            jgeom.linearize_depth(jnp.asarray(rgbd[..., 3:]), 0.6, 5.0), padding="frustum",
            fov=45.0, modelview=mv, atol=0.03, rtol=0.03, erode_rgb=3, cal_normal=True))
        colors.append(rgbd[..., :3])
    jscene.save_scene(path, meshes, colors)
    data = np.load(path, allow_pickle=True)["data"]
    data[1]["modelview"] = np.ascontiguousarray(data[1]["modelview"].T)
    np.savez_compressed(path, data=data)


def test_load_scene_matches_jax(tmp_path):
    path = str(tmp_path / "scene.npz")
    _jax_scene(path)
    want_meshes, want_colors = jscene.load_scene(path)
    meshes, colors = scene_io.load_scene(path, device="cpu")
    assert len(meshes) == len(colors) == len(want_meshes) == 2
    for m, c, wm, wc in zip(meshes, colors, want_meshes, want_colors):
        assert c.dtype == np.float32 and c.shape == (16, 16, 3)
        np.testing.assert_array_equal(c, np.asarray(wc))
        np.testing.assert_array_equal(m.depth.numpy(), np.asarray(wm.depth))
        assert m.fov == float(wm.fov)
        np.testing.assert_array_equal(m.faces.numpy(), np.asarray(wm.faces))
        np.testing.assert_array_equal(m.flag.numpy(), np.asarray(wm.flag))
        for f in ("positions", "uv", "normal", "modelview"):
            np.testing.assert_allclose(getattr(m, f).numpy(), np.asarray(getattr(wm, f)),
                                       atol=1e-6, rtol=1e-6, err_msg=f)
        np.testing.assert_array_equal(m.modelview[3].numpy(), [0, 0, 0, 1])


def test_load_first_view_matches_jax(tmp_path):
    path = str(tmp_path / "scene.npz")
    _jax_scene(path)
    want = jscene.load_first_view(path, near=0.6, far=5.0)
    got = scene_io.load_first_view(path, near=0.6, far=5.0)
    assert got.shape == (16, 16, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :3], want[..., :3])
    np.testing.assert_allclose(got[..., 3:], want[..., 3:], atol=1e-6, rtol=0)
