"""The port's file-backed datasets and native resampler vs the JAX package
(CPU), and the training CLI on a PNG folder.

Each package reads its own copy of a seeded folder (``dataset.json``, the
listing's cache, is written into the folder): PNGs in RGB, gray and RGBA,
JPEGs (RGB and gray, through PIL) for ImageNet, and npz disparities.

Tolerances, and why:
- ``x_0`` RGB bit-equal: both run the same resampler source with the same
  flags (within 1.01/255, one 8-bit level, where the JAX package has no
  native library and falls back to PIL).
- Depth bit-equal: the port's nearest-neighbour index rule is PIL's.
- SR ``y`` within 1.01/255 + 1e-5: the JAX package takes it from PIL and
  blurs with cv2, the port from the native resampler (PIL's premultiplied
  alpha reproduced for RGBA) and its own blur; the Gaussian weights and the
  f32 sums differ in their last bits.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import ivid_tpu.data as jdata
from ivid_tpu.data import native as jnative
from ivid_tpu.data.base import _lanczos_resize_center_crop
from ivid_tpu_torch import train
from ivid_tpu_torch.data import base, native
import ivid_tpu_torch.data as tdata
from ivid_tpu_torch.training.trainer import StepRecord
from ivid_tpu_torch.utils.images import png_encode

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["none", "to_depth", "disparity_minmax", "depth_minmax", "z_buffer"]
RGB_TOL = 0.0 if jnative.available() else 1.01 / 255
SR_TOL = 1.01 / 255 + 1e-5
CLASSES = ["ImageNet", "ImageNetSR", "ImageNetWarp", "SingleCategory", "SingleCategorySR",
           "SingleCategoryWarp"]


def _image(rng, shape, channels):
    img = rng.integers(0, 256, shape + (channels,), dtype=np.uint8)
    return img[..., 0] if channels == 1 else img


def write_folder(root, kind="single", n=6, seed=0):
    """A seeded RGBD folder: ``images/`` and ``depths/`` (disparities up to
    20000, so that the 1/near scaling runs too). ``kind`` "single": PNGs
    cycling RGB, gray and RGBA, landscape and portrait; "imagenet": two
    label folders of JPEGs (RGB and gray)."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        shape = (75, 100) if i % 2 == 0 else (100, 75)
        if kind == "single":
            rel, channels = f"{i:03d}", (3, 1, 4)[i % 3]
        else:
            rel, channels = f"n0{i % 2}/{i:03d}", (3, 1)[(i // 2) % 2]
        os.makedirs(os.path.dirname(os.path.join(root, "images", rel)), exist_ok=True)
        os.makedirs(os.path.dirname(os.path.join(root, "depths", rel)), exist_ok=True)
        img = _image(rng, shape, channels)
        if kind == "single":
            with open(os.path.join(root, "images", rel + ".png"), "wb") as f:
                f.write(png_encode(img))
        else:
            from PIL import Image

            Image.fromarray(img).save(os.path.join(root, "images", rel + ".JPEG"), quality=90)
        np.savez(os.path.join(root, "depths", rel + ".npz"),
                 rng.uniform(500, 20000, shape).astype(np.float32))
    return str(root)


def _pair(tmp_path, name, mode, n=6):
    """(port dataset, JAX dataset) of class ``name`` on two copies of one folder."""
    kind = "imagenet" if name.startswith("ImageNet") else "single"
    src = write_folder(tmp_path / "jax", kind, n)
    shutil.copytree(src, tmp_path / "port")
    kw = dict(image_size=32, normalize=True, normalize_depth=mode not in ("none", "to_depth"),
              prepocess_depth=mode)
    if name.endswith("SR"):
        kw["image_size_lr"] = 16
    if name.endswith("Warp"):
        kw.update(augments=["blur", "erode_rgb"], std=0.2)
    return (tdata.DATASETS[name](str(tmp_path / "port"), **kw),
            jdata.DATASETS[name](src, **kw))


def _assert_items_match(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    np.testing.assert_allclose(got["x_0"][..., :3], want["x_0"][..., :3], atol=RGB_TOL, rtol=0)
    np.testing.assert_array_equal(got["x_0"][..., 3], want["x_0"][..., 3])
    if "classes" in want:
        assert got["classes"] == want["classes"]
    if "y" in want:
        np.testing.assert_allclose(got["y"][..., :3], want["y"][..., :3], atol=SR_TOL, rtol=0)
        np.testing.assert_array_equal(got["y"][..., 3], want["y"][..., 3])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CLASSES)
def test_file_dataset_items_match_jax(tmp_path, name, mode):
    got, want = _pair(tmp_path, name, mode)
    assert (got.images, got.depths, got.labels, got.num_classes) == (
        want.images, want.depths, want.labels, want.num_classes)
    if name.endswith("Warp"):
        assert (got.augments, got.std) == (want.augments, want.std)
    for i in range(len(want)):
        # The SR blur's sigma comes from the global numpy state.
        np.random.seed(i)
        a = got[i]
        np.random.seed(i)
        b = want[i]
        _assert_items_match(a, b)


@pytest.mark.parametrize("kind,cls", [("single", "SingleCategory"), ("imagenet", "ImageNet")])
def test_listing_cache_is_shared_with_jax(tmp_path, kind, cls):
    """Each package writes ``dataset.json`` byte for byte as the other does
    and lists a folder from the other's cache as from its own files."""
    a = write_folder(tmp_path / "a", kind)
    shutil.copytree(a, tmp_path / "b")
    kw = dict(image_size=16)
    port, jax_ds = tdata.DATASETS[cls](a, **kw), jdata.DATASETS[cls](str(tmp_path / "b"), **kw)
    with open(os.path.join(a, "dataset.json"), "rb") as f, \
            open(tmp_path / "b" / "dataset.json", "rb") as g:
        assert f.read() == g.read()
    cross = [tdata.DATASETS[cls](str(tmp_path / "b"), **kw), jdata.DATASETS[cls](a, **kw)]
    for ds in cross:
        assert (ds.images, ds.depths, ds.labels) == (port.images, port.depths, port.labels)
    with open(os.path.join(a, "dataset.json")) as f:
        assert len(json.load(f)["images"]) == 6


def test_native_resampler_equals_jax_library_and_pil():
    rng = np.random.default_rng(0)
    for (h, w), c, size in [((200, 130), 3, 48), ((64, 200), 1, 48), ((129, 77), 4, 32),
                            ((375, 500), 3, 128)]:
        img = _image(rng, (h, w), c)
        got = native.lanczos_resize_center_crop(img, size)
        assert got.shape == (size, size, c) and got.dtype == np.float32
        if jnative.available():
            np.testing.assert_array_equal(got, jnative.lanczos_resize_center_crop(img, size))
        if c != 4:  # PIL resizes RGBA through premultiplied alpha
            from PIL import Image

            ref = np.asarray(_lanczos_resize_center_crop(Image.fromarray(img), size,
                                                         Image.LANCZOS), np.float32) / 255
            np.testing.assert_allclose(got.reshape(ref.shape), ref, atol=1.01 / 255, rtol=0)
    with pytest.raises(ValueError, match="uint8"):
        native.lanczos_resize_center_crop(np.zeros((8, 8), np.float32), 4)


def test_nearest_resize_and_premultiplied_lanczos_equal_pil():
    from PIL import Image

    rng = np.random.default_rng(1)
    for h, w, size in [(64, 200, 48), (200, 64, 48), (75, 100, 32), (100, 75, 16),
                       (375, 500, 128), (500, 375, 128), (1000, 701, 256), (129, 77, 33)]:
        d = rng.uniform(size=(h, w)).astype(np.float32)
        want = np.asarray(_lanczos_resize_center_crop(Image.fromarray(d), size, Image.NEAREST))
        np.testing.assert_array_equal(base.nearest_resize_center_crop(d, size), want)
    for h, w in [(75, 100), (129, 77)]:
        img = _image(rng, (h, w), 4)
        img[:4, :, 3] = 0
        img[4:8, :, 3] = 255
        want = np.asarray(_lanczos_resize_center_crop(Image.fromarray(img), 16, Image.LANCZOS))
        np.testing.assert_array_equal(base._pil_lanczos_levels(img, 16), want)


def test_damaged_file_retries_like_jax(tmp_path):
    got, want = _pair(tmp_path, "SingleCategory", "z_buffer")
    for root in (got.root_path, want.root_path):
        with open(os.path.join(root, "images", "002.png"), "wb") as f:
            f.write(b"not an image")
    np.random.seed(5)
    a = got[2]
    np.random.seed(5)
    b = want[2]
    _assert_items_match(a, b)


def test_jpeg_without_pil_names_the_file(tmp_path, monkeypatch):
    root = write_folder(tmp_path, "imagenet", n=2)
    ds = tdata.ImageNet(root, image_size=16)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=r"000\.JPEG.*PIL"):
        ds.get_file(0)


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "image_ops.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error:"):
        native.lanczos_resize_center_crop(np.zeros((4, 4, 3), np.uint8), 2)
    assert [p.name for p in (tmp_path / "_build").iterdir()] == ["image_ops.lock"]


def tiny_cond_config(tmp_path, **trainer_args):
    """The single-category cond config cut to a 16² f32 UNet, on a
    SingleCategoryWarp folder at 16²; the path of the written copy."""
    with open(os.path.join(REPO, "configs", "rgbd_singlecategory_adm_128_small_cond.json")) as f:
        cfg = json.load(f)
    cfg["backbone"]["args"].update(image_size=16, model_channels=16, num_res_blocks=1,
                                   channel_mult=[1, 2], attention_resolutions=[8],
                                   num_groups=8, num_head_channels=16, use_fp16=False)
    cfg["dataset"]["args"]["image_size"] = 16
    cfg["framework"]["args"]["timesteps"] = 100
    cfg["trainer"]["args"].update(dict(batch_size_per_gpu=2, sample_at_init=False, i_save=2,
                                       i_log=1), **trainer_args)
    path = tmp_path / "rgbd_singlecategory_adm_128_small_cond.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_train_cli_on_png_single_category_folder(tmp_path):
    """``python -m ivid_tpu_torch.train --device cpu`` on a PNG folder with
    the file-backed SingleCategoryWarp: 2 steps, a checkpoint, finite losses."""
    data = write_folder(tmp_path / "data", "single", n=8)
    argv = ["--config", tiny_cond_config(tmp_path), "--data_dir", data, "--output_dir",
            str(tmp_path / "out"), "--max_steps", "2", "--device", "cpu", "--num_workers", "2"]
    rec = StepRecord()
    tr = train.main(argv, record=rec)
    assert type(tr.dataset).__name__ == "SingleCategoryWarp" and tr.step == 2
    assert len(rec.losses) == 2 and all(np.isfinite(float(x)) for x in rec.losses)
    run_dir = tmp_path / "out" / "rgbd_singlecategory_adm_128_small_cond"
    assert "model_step0000002.pt" in os.listdir(run_dir / "ckpts")
    assert tr._loader_obj.items_loaded >= 4
