"""The port's host-side pieces vs the JAX package (CPU): configs, viewsets,
the 3x9 display reorder, int-list parsing, and PNG writing.

All exact: the port copies these in numpy (viewsets) or the standard library
(PNG via zlib), and the same inputs must give the same matrices, lists and
decoded pixels.
"""

import glob
import os

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivid_tpu import config as jconfig
from ivid_tpu.diffusion import build_framework as jax_framework
from ivid_tpu.inference import viewsets as jviews
from ivid_tpu.utils import images as jimages
from ivid_tpu_torch import config as tconfig
from ivid_tpu_torch.inference import viewsets as tviews
from ivid_tpu_torch.utils import images as timages

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_load_like_jax(path):
    got, want = tconfig.Config.load(path), jconfig.Config.load(path)
    for section in ("backbone", "framework", "dataset", "trainer", "extra"):
        assert getattr(got, section) == getattr(want, section), section


def test_build_from_config_matches_jax():
    """The synthetic test config through both builders: the same framework
    class and schedule, an f32 torso (``use_fp16: false``), and every
    parameter named as the reference names it."""
    from ivid_tpu.models.torch_compat import torch_state_dict_to_flax

    path = os.path.join(REPO, "configs", "rgbd_synthetic_adm_32_test.json")
    cfg = tconfig.Config.load(path)
    model = tconfig.build_backbone(cfg)
    fw = tconfig.build_framework_from_config(cfg, model)
    jcfg = jconfig.Config.load(path)
    jfw = jax_framework(jcfg.framework["name"], None, jcfg.framework["args"])
    assert type(fw).__name__ == type(jfw).__name__ == "ClassifierFreeGuidance"
    assert fw.p_uncond == jfw.p_uncond
    np.testing.assert_array_equal(fw.schedule.alphas_cumprod.numpy(),
                                  np.asarray(jfw.schedule.alphas_cumprod))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = torch_state_dict_to_flax(sd, **cfg.backbone["args"])
    n_leaves = sum(np.asarray(x).size for x in _leaves(tree))
    assert n_leaves == sum(p.numel() for p in model.parameters())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("name", ["uncond", "random", "3x9"])
def test_viewsets_match_jax(name):
    got = tviews.build_viewset(name, 3, rng=np.random.default_rng(7))
    want = jviews.build_viewset(name, 3, rng=np.random.default_rng(7))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).shape == {"uncond": (1, 4, 4), "random": (3, 2, 4, 4),
                                     "3x9": (27, 4, 4)}[name]


@pytest.mark.parametrize("n_views", [26, 27])
def test_reorder_matches_jax(n_views):
    imgs = np.random.default_rng(n_views).uniform(-1, 1, (n_views, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(tviews.reorder(imgs), jviews.reorder(imgs))


def test_parse_int_list_matches_jax():
    for s in ("0-8", "3", "0-2,7,10-11"):
        assert timages.parse_int_list(s) == jimages.parse_int_list(s)


@pytest.mark.parametrize("channels", [None, 1, 3, 4])
def test_png_writer_matches_jax(tmp_path, channels):
    """``save_image`` (zlib PNG) and ``save_image_grid`` decode to the pixels
    the JAX package's imageio writer stores."""
    shape = (5, 7) if channels is None else (5, 7, channels)
    img = np.random.default_rng(3).uniform(-0.2, 1.2, shape).astype(np.float32)
    timages.save_image(str(tmp_path / "port.png"), img)
    jimages.save_image(str(tmp_path / "jax.png"), img)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "port.png"),
                                  imageio.imread(tmp_path / "jax.png"))
    if channels == 3:
        stack = np.random.default_rng(4).uniform(-1, 1, (5, 6, 6, 3)).astype(np.float32)
        timages.save_image_grid(str(tmp_path / "pg.png"), stack, nrow=3)
        jimages.save_image_grid(str(tmp_path / "jg.png"), stack, nrow=3)
        got = imageio.imread(tmp_path / "pg.png")
        assert got.shape == (2 * 8 + 2, 3 * 8 + 2, 3)
        np.testing.assert_array_equal(got, imageio.imread(tmp_path / "jg.png"))


def test_cli_device_defaults_to_cuda():
    """The CLIs run on the card unless the caller asks for the CPU."""
    from ivid_tpu_torch import sample, train

    assert sample.parse_args([]).device == "cuda"
    assert sample.parse_args(["--device", "cpu"]).device == "cpu"
    assert train.parse_args(["--config", "c.json"]).device == "cuda"
