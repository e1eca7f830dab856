"""The port's evals vs the JAX package's ``ivid_tpu.evals`` and root ``eval.py`` (CPU).

Tolerances and why:
- the statistics, FID, KID and IS on the same features: 1e-10 relative
  (the same float64 numpy and scipy code);
- the RandConv weights: bit-equal (the port draws them with its own
  threefry-2x32 and XLA's float32 erfinv, :mod:`ivid_tpu_torch.evals.threefry`);
- RandConv features on seeded 32² and 33² images: 1e-4 (f32 convolutions
  summed in another order; 33² checks the odd-size "SAME" padding);
- InceptionV3 on a seeded state dict at 64²: 1e-4 absolute on features up to
  ~25 (f32 against f32, ~100 layers in another order);
- ``resize_tf1``: exactly, against the JAX function run op by op (under
  ``jit`` XLA fuses its multiply-adds, which moves a value by one ulp);
- metrics from RandConv features (``compute_metrics``, ``eval.main``):
  1e-6 relative plus 1e-7 absolute (the features differ by f32 sum order,
  which moves FID over 2048-d Gaussians by ~1e-8 relative; IS is computed
  from float32 logits in float32, in both packages, so its mean near 1 and
  its spread carry float32 rounding of ~1e-8 absolute; the KID spread over
  subsets that are the whole set is zero up to rounding).
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ivid_tpu.data.collect import collect_data as jax_collect_data
from ivid_tpu.evals import inception as jinc
from ivid_tpu.evals import metrics as jmet
from ivid_tpu_torch import eval as teval
from ivid_tpu_torch.data import collect_data
from ivid_tpu_torch.evals import inception as tinc
from ivid_tpu_torch.evals import metrics as tmet
from ivid_tpu_torch.evals import threefry
from ivid_tpu_torch.utils.images import png_encode

torch.set_num_threads(2)


def close(got, want):
    for k, w in want.items():
        if isinstance(w, str):
            assert got[k] == w, k
        else:
            assert abs(got[k] - w) <= 1e-6 * abs(w) + 1e-7, (k, got[k], w)


@pytest.fixture(scope="module")
def jax_randconv():
    return jmet.RandConvFeatures(seed=0)


def _feats(seed, n=40, d=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * rng.uniform(0.5, 2, d) + rng.normal(0, 0.3, d)
            ).astype(np.float32)


@pytest.mark.parametrize("stat", ["feature_statistics", "frechet_distance",
                                  "kernel_inception_distance", "inception_score"])
def test_statistics_match(stat):
    f1, f2 = _feats(0), _feats(1)
    if stat == "feature_statistics":
        for g, w in zip(tmet.feature_statistics(f1), jmet.feature_statistics(f1)):
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=0)
        return
    if stat == "frechet_distance":
        args = (*jmet.feature_statistics(f1), *jmet.feature_statistics(f2))
        got, want = {"fid": tmet.frechet_distance(*args)}, {"fid": jmet.frechet_distance(*args)}
    elif stat == "kernel_inception_distance":
        got = tmet.kernel_inception_distance(f1, f2, subset_size=30, num_subsets=20)
        want = jmet.kernel_inception_distance(f1, f2, subset_size=30, num_subsets=20)
    else:
        got, want = tmet.inception_score(f1 * 3, splits=4), jmet.inception_score(f1 * 3, splits=4)
    assert got.keys() == want.keys()
    for k in want:
        assert want[k] != 0 and abs(got[k] - want[k]) <= 1e-10 * abs(want[k]), k


def test_randconv_weights_are_jax_draws(jax_randconv):
    ext = tmet.RandConvFeatures(seed=0, device="cpu")
    want = [np.asarray(k) for k in jax_randconv.params] + [np.asarray(jax_randconv.head)]
    got = [k.permute(2, 3, 1, 0).numpy() for k in ext.kernels] + [ext.head.numpy()]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def test_threefry_matches_jax():
    key = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(threefry.prng_key(7), np.asarray(key))
    np.testing.assert_array_equal(threefry.split(threefry.prng_key(7), 3),
                                  np.asarray(jax.random.split(key, 3)))
    np.testing.assert_array_equal(threefry.random_bits(threefry.prng_key(7), (5, 7)),
                                  np.asarray(jax.random.bits(key, (5, 7), jnp.uint32)))
    # erfinv over the whole range, its tails and both branches of log1p.
    u = np.concatenate([np.linspace(-1, 1, 20001, dtype=np.float32),
                        1 - np.logspace(-7, -1, 200).astype(np.float32),
                        np.nextafter(np.float32(-1), np.float32(0))[None]]).astype(np.float32)
    np.testing.assert_array_equal(threefry.erfinv(u).view(np.int32),
                                  np.asarray(jax.lax.erf_inv(jnp.asarray(u))).view(np.int32))


@pytest.mark.parametrize("size", [32, 33])
def test_randconv_features_match(jax_randconv, size):
    rng = np.random.default_rng(size)
    imgs = rng.uniform(size=(3, size, size, 3)).astype(np.float32)
    ext = tmet.RandConvFeatures.from_arrays(jax_randconv.params, jax_randconv.head, "cpu")
    gf, gl = ext(imgs, batch=2)
    wf, wl = jax_randconv(imgs, batch=2)
    assert gf.shape == (3, 2048) and gl.shape == (3, 1008)
    np.testing.assert_allclose(gf, wf, atol=1e-4, rtol=0)
    np.testing.assert_allclose(gl, wl, atol=1e-4, rtol=0)


def test_inception_matches_jax(tmp_path):
    sd = tinc.seeded_state_dict(0)
    assert list(sd) == jinc.expected_keys() == tinc.expected_keys()
    path = tmp_path / "inception.pt"
    torch.save(sd, path)
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    gf, gl = tinc.InceptionFeatures(str(path), device="cpu")(imgs)
    wf, wl = jinc._make_forward(jinc.load_torch_weights(str(path)))(imgs)
    wf, wl = np.asarray(wf), np.asarray(wl)
    assert gf.shape == (2, 2048) and gl.shape == (2, 1008) and np.abs(wf).max() > 1
    np.testing.assert_allclose(gf, wf, atol=1e-4, rtol=0)
    np.testing.assert_allclose(gl, wl, atol=1e-4, rtol=0)
    # A torch-fidelity file with a prefix and BatchNorm counters loads the same.
    extra = {f"model.{k}": v for k, v in sd.items()}
    extra["model.Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(0)
    torch.save({"state_dict": extra}, tmp_path / "prefixed.pt")
    loaded = tinc.load_torch_weights(str(tmp_path / "prefixed.pt"))
    assert all(torch.equal(loaded[k], sd[k]) for k in sd) and list(loaded) == list(sd)


def _jax_resize_tf1():
    """``resize_tf1`` as ``ivid_tpu.evals.inception._make_forward`` defines
    it (a closure over ``jnp``)."""
    code = next(c for c in jinc._make_forward.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "resize_tf1")
    assert code.co_freevars == ("jnp",)
    return types.FunctionType(code, jinc.__dict__, "resize_tf1", (299,),
                              (types.CellType(jnp),))


def test_resize_tf1_is_exact():
    x = np.random.default_rng(3).uniform(size=(2, 37, 53, 3)).astype(np.float32)
    want = np.asarray(_jax_resize_tf1()(jnp.asarray(x)))
    got = tinc.resize_tf1(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_array_equal(got, want)


class CountingExtractor:
    def __init__(self):
        self.calls = 0

    def __call__(self, images):
        self.calls += 1
        f = images.reshape(len(images), -1)[:, :8].astype(np.float32)
        return f, f[:, :4]


def test_extract_features_cache_and_fingerprint(tmp_path):
    imgs = np.random.default_rng(4).uniform(size=(5, 8, 8, 3)).astype(np.float32)
    assert tmet._image_set_fingerprint(imgs) == jmet._image_set_fingerprint(imgs)
    path = str(tmp_path / "c" / "real-feats-x.npz")
    ext = CountingExtractor()
    f1, _ = tmet.extract_features(imgs, ext, path)
    f2, _ = tmet.extract_features(imgs, ext, path)
    assert ext.calls == 1 and np.array_equal(f1, f2)
    # The JAX package reads the port's cache (and the other way round).
    jext = CountingExtractor()
    jf, _ = jmet.extract_features(imgs, jext, path)
    assert jext.calls == 0 and np.array_equal(jf, f1)
    changed = imgs.copy()
    changed[2, 0, 0, 0] += 0.5  # same count, new content: recomputed
    tmet.extract_features(changed, ext, path)
    assert ext.calls == 2


def _write_pngs(directory, images):
    os.makedirs(directory, exist_ok=True)
    for i, img in enumerate(images):
        with open(os.path.join(directory, f"{i:03d}.png"), "wb") as f:
            f.write(png_encode(img))


def _root_eval():
    """The repo's root ``eval.py`` as a module (its loaders read with PIL)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "root_eval", os.path.join(os.path.dirname(os.path.dirname(__file__)), "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def image_sets(tmp_path_factory):
    """24 fake and 24 real 32² seeded PNGs; the images root ``eval.py``
    loads from them (PIL, the fakes in its seeded order) and the JAX
    package's metrics of those."""
    root = tmp_path_factory.mktemp("evalsets")
    rng = np.random.default_rng(5)
    _write_pngs(root / "fake", (rng.uniform(size=(24, 32, 32, 3)) * 200).astype(np.uint8))
    _write_pngs(root / "real", (rng.uniform(size=(24, 32, 32, 3)) * 255).astype(np.uint8))
    ref = _root_eval()
    fake = ref.load_fake_images(str(root / "fake"), 32, 10000)
    real = ref.load_real_images(str(root / "real"), 32)
    return root, fake, real, jmet.compute_metrics(fake, real)


def test_compute_metrics_randconv_matches_jax(image_sets, tmp_path):
    _, fake, real, want = image_sets
    got = tmet.compute_metrics(fake, real, cache_dir=str(tmp_path), real_name="real",
                               device="cpu")
    assert got["feature_extractor"] == "randconv" and got["frechet_inception_distance"] > 0
    close(got, want)
    assert os.path.exists(tmp_path / "real-feats-randconv.npz")


def test_eval_cli_matches_jax(image_sets, tmp_path):
    root, fake, real, want = image_sets
    tmp = tmp_path / "metrics" / "cache"
    argv = ["--real_images_dir", str(root / "real"), "--fake_images_dir", str(root / "fake"),
            "--tmp_dir", str(tmp), "--image_size", "32", "--yes", "--device", "cpu",
            "--fake_images_cache_name", "fakes"]
    got = teval.main(argv)
    close(got, want)
    assert (tmp_path / "metrics" / "fakes.txt").read_text() == str(got)
    cached = np.load(tmp / f"{str(root / 'real').replace('/', '_')}-32-images.npz")["images"]
    assert cached.dtype == np.uint8 and cached.shape == (24, 32, 32, 3)


def test_square_pngs_read_without_pil_as_pil_reads_them(tmp_path):
    """A square PNG at ``--image_size`` goes through PIL's crop and resize
    unchanged; the port reads it without PIL, to the same pixels, for
    every 8-bit colour type PIL writes."""
    rng = np.random.default_rng(6)
    rgb = (rng.uniform(size=(16, 16, 3)) * 255).astype(np.uint8)
    for mode, img in (("RGB", Image.fromarray(rgb)), ("RGBA", Image.fromarray(rgb).convert("RGBA")),
                      ("L", Image.fromarray(rgb[..., 0])),
                      ("LA", Image.fromarray(rgb[..., 0]).convert("LA"))):
        path = str(tmp_path / f"{mode}.png")
        img.save(path)
        want = np.asarray(teval.center_crop_and_resize(Image.open(path), 16).convert("RGB"),
                          np.float32) / 255.0
        np.testing.assert_array_equal(teval.load_image(path, 16, crop=True), want, err_msg=mode)
        np.testing.assert_array_equal(teval.load_image(path, 16, crop=False), want, err_msg=mode)
    # Anything else goes through PIL: a 20x24 image is cropped and resized.
    path = str(tmp_path / "wide.png")
    Image.fromarray((rng.uniform(size=(20, 24, 3)) * 255).astype(np.uint8)).save(path)
    want = np.asarray(teval.center_crop_and_resize(Image.open(path), 16), np.float32) / 255.0
    np.testing.assert_array_equal(teval.load_image(path, 16, crop=True), want)


def test_images_that_need_pil_name_the_file(tmp_path, monkeypatch):
    path = str(tmp_path / "wide.png")
    with open(path, "wb") as f:
        f.write(png_encode(np.zeros((20, 24, 3), np.uint8)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="wide.png"):
        teval.load_image(path, 16, crop=True)


class ListDataset:
    def __init__(self, n=11):
        rng = np.random.default_rng(7)
        self.items = [{"x": rng.uniform(size=(4, 4, 3)).astype(np.float32), "y": i}
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_collect_data_matches_jax():
    ds = ListDataset()
    got, want = collect_data(ds, [0, 5, 9, 3]), jax_collect_data(ds, [0, 5, 9, 3])
    assert got.keys() == want.keys() == {"x", "y"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("extractor", ["randconv", "inception:none.pt"])
def test_eval_cli_needs_the_card_by_default(tmp_path, extractor):
    """Without ``--device`` the CLI runs on ``cuda``: with no card it raises
    before it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp = tmp_path / "cache"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(["--real_images_dir", str(tmp_path), "--fake_images_dir", str(tmp_path),
                    "--tmp_dir", str(tmp), "--extractor", extractor])
    assert not tmp.exists()
