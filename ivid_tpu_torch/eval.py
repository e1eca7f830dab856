"""Evaluation CLI: FID / IS / KID between generated and real image sets,
``python -m ivid_tpu_torch.eval --fake_images_dir DIR --real_images_dir DIR``.

The port of the repo's ``eval.py``, with its flags, plus ``--device``
(default ``cuda``; ``cpu`` computes the features on the CPU, and ``cuda``
without a card raises). It samples up to ``--num_samples`` fakes (PNG files,
in a seeded order), center-crops and resizes the reals, caches the
processed real set (``{tmp_dir}/{name}-images.npz``, with an interactive
overwrite prompt unless ``--yes``) and the real features
(``{name}-feats-{extractor}.npz``), and writes the metrics to
``{metrics_dir}/{fake_cache_name}.txt``. The extractor
(``ivid_tpu_torch.evals.metrics``): ``randconv`` (default) or
``inception:<path>``, a torch-fidelity InceptionV3 weights file given at run
time (the repository holds none).

PNG files are read with the port's own decoder. A JPEG, or an image that is
not already square at ``--image_size``, needs PIL (imported only then) for
the center crop and Lanczos resize; without it the error names the file. A
square PNG at ``--image_size`` goes through PIL's ``resize`` unchanged in the
reference, so it is read as it is.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np
import torch


def center_crop_and_resize(image, image_size):
    """(reference: eval.py:41-47); ``image`` a PIL image."""
    from PIL import Image

    w, h = image.size
    if w > h:
        image = image.crop(((w - h) // 2, 0, (w + h) // 2, h))
    elif h > w:
        image = image.crop((0, (h - w) // 2, w, (h + w) // 2))
    return image.resize((image_size, image_size), Image.LANCZOS)


def _png_rgb(path: str):
    """An 8-bit PNG's RGB [H,W,3] uint8, or None where the port's decoder
    cannot give it as PIL's ``convert("RGB")`` would (palette images)."""
    from ivid_tpu_torch.utils.images import png_decode

    with open(path, "rb") as f:
        data = f.read()
    try:
        arr = png_decode(data)
    except ValueError:
        return None
    if arr.ndim == 2:
        arr = arr[..., None]
    c = arr.shape[-1]
    if c in (1, 2):
        return np.repeat(arr[..., :1], 3, axis=-1)
    return arr[..., :3]


def load_image(path: str, image_size: int, crop: bool) -> np.ndarray:
    """[image_size, image_size, 3] float32 in [0,1]. A PNG that decodes to
    ``image_size``² is read without PIL; otherwise PIL crops (``crop``) and
    resizes, or the size is checked (fakes)."""
    arr = _png_rgb(path) if path.lower().endswith(".png") else None
    if arr is not None and arr.shape[:2] == (image_size, image_size):
        return arr.astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: reading this image needs PIL, which is not installed "
                           f"(only {image_size}² PNG files are read without it)") from None
    img = Image.open(path)
    if crop:
        if img.mode == "CMYK":
            img = img.convert("RGB")
        img = center_crop_and_resize(img, image_size).convert("RGB")
    else:
        img = img.convert("RGB")
        if img.size != (image_size, image_size):
            raise ValueError(f"{path}: size {img.size}, expected {image_size}²")
    return np.asarray(img, np.float32) / 255.0


def load_fake_images(fake_dir, image_size, num_samples):
    """(reference: eval.py:50-71)."""
    paths = sorted(glob(os.path.join(fake_dir, "*.png")))
    print(f"Found {len(paths)} fake images")
    rng = np.random.default_rng(0)
    paths = [paths[i] for i in rng.permutation(len(paths))]
    out = []
    for p in paths:
        try:
            out.append(load_image(p, image_size, crop=False))
        except (OSError, ValueError) as e:  # skip unreadable files, like the reference
            print(e)
            continue
        if len(out) == num_samples:
            break
    print(f"Loaded {len(out)} fake images")
    return np.stack(out)


def load_real_images(real_dir, image_size, num_samples=None):
    """(reference: eval.py:74-90)."""
    paths = []
    for ext in ["png", "jpg", "jpeg", "PNG", "JPG", "JPEG"]:
        paths += glob(os.path.join(real_dir, "**", f"*.{ext}"), recursive=True)
    if num_samples is not None and len(paths) > num_samples:
        rng = np.random.default_rng(0)
        paths = [paths[i] for i in rng.choice(len(paths), num_samples, replace=False)]
    out = []
    for p in paths:
        try:
            out.append(load_image(p, image_size, crop=True))
        except (OSError, ValueError) as e:
            print(e)
    print(f"Loaded {len(out)} real images")
    return np.stack(out)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--real_images_dir", type=str, default=None)
    p.add_argument("--fake_images_dir", type=str, default=None)
    p.add_argument("--tmp_dir", type=str, default="metrics/cache")
    p.add_argument("--metrics_dir", type=str, default=None,
                   help="where the <fake_cache_name>.txt result lands; "
                        "defaults to the parent of --tmp_dir")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--num_samples", type=int, default=10000)
    p.add_argument("--max_real_images", type=int, default=None,
                   help="cap the real set (random subset, seeded); the full set is the "
                        "reference protocol, but it is held in RAM as float32")
    p.add_argument("--real_images_cache_name", type=str, default=None)
    p.add_argument("--fake_images_cache_name", type=str, default=None)
    p.add_argument("--use_real_images_cache", action="store_true")
    p.add_argument("--extractor", type=str, default="randconv")
    p.add_argument("--yes", action="store_true", help="non-interactive overwrite")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns the metrics dict (also written to
    ``{metrics_dir}/{fake_images_cache_name}.txt``)."""
    opt = parse_args(argv)
    from ivid_tpu_torch.evals import compute_metrics

    if torch.device(opt.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("eval: no CUDA device (pass --device cpu to compute on the CPU)")
    # Default cache names carry the image size: a cache written at one
    # --image_size must never be reused at another (the fingerprint check in
    # extract_features does not see the processed set's resolution).
    if opt.real_images_cache_name is None:
        opt.real_images_cache_name = f"{opt.real_images_dir.replace('/', '_')}-{opt.image_size}"
    if opt.fake_images_cache_name is None:
        opt.fake_images_cache_name = f"{opt.fake_images_dir.replace('/', '_')}-{opt.image_size}"
    os.makedirs(opt.tmp_dir, exist_ok=True)
    real_cache = os.path.join(opt.tmp_dir, f"{opt.real_images_cache_name}-images.npz")

    if opt.use_real_images_cache and os.path.exists(real_cache):
        print("Using cached real images")
        real = np.load(real_cache)["images"]
    else:
        real = None
        if os.path.exists(real_cache) and not opt.yes:
            if input("Real images cache found. Overwrite? (y/n)\n") != "y":
                real = np.load(real_cache)["images"]
        if real is None:
            real = load_real_images(opt.real_images_dir, opt.image_size,
                                    num_samples=opt.max_real_images)
            np.savez_compressed(real_cache, images=(real * 255).astype(np.uint8))
    if real.dtype == np.uint8:
        real = real.astype(np.float32) / 255.0

    fake = load_fake_images(opt.fake_images_dir, opt.image_size, opt.num_samples)
    # Real-set features always cache (the expensive half at 10k+ images);
    # fake features are always fresh: the fake dir is regenerated between
    # evals under the same name.
    metrics = compute_metrics(fake, real, extractor=opt.extractor, cache_dir=opt.tmp_dir,
                              real_name=opt.real_images_cache_name, device=opt.device)
    print(metrics)
    metrics_dir = opt.metrics_dir or os.path.dirname(opt.tmp_dir.rstrip("/")) or "metrics"
    os.makedirs(metrics_dir, exist_ok=True)
    with open(os.path.join(metrics_dir, f"{opt.fake_images_cache_name}.txt"), "w") as f:
        f.write(str(metrics))
    return metrics


if __name__ == "__main__":
    main()
