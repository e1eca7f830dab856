"""The port's depth images against the JAX package's (cv2's INFERNO
colormap, installed where the tests run), on seeded depths across the whole
[vmin, vmax] range and past it: equal on every pixel."""

import numpy as np
import pytest

from ivid_tpu.utils import images as jimages
from ivid_tpu_torch.utils import images as timages


@pytest.mark.parametrize("shape", [(16, 16), (16, 16, 1), (3, 16, 16), (3, 16, 16, 1)])
def test_colorize_depth_equals_jax_inferno(shape):
    d = np.random.default_rng(0).uniform(-1.6, 1.6, shape).astype(np.float32)
    got, want = timages.colorize_depth(d), jimages.colorize_depth(d)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vmin, vmax", [(-1.0, 1.0), (0.0, 5.0)])
def test_colorize_depth_covers_every_level(vmin, vmax):
    """A ramp through all 256 levels of the colormap, with both ends past
    the range (clipped)."""
    d = np.linspace(vmin - 0.5, vmax + 0.5, 4096, dtype=np.float32).reshape(64, 64)
    np.testing.assert_array_equal(timages.colorize_depth(d, vmin, vmax),
                                  jimages.colorize_depth(d, vmin, vmax))


def test_inferno_table_is_cv2s():
    import cv2

    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[None], cv2.COLORMAP_INFERNO)
    np.testing.assert_array_equal(timages.INFERNO, cv2.cvtColor(lut, cv2.COLOR_BGR2RGB)[0])
