"""Port textured render, forward-backward warp and warp-conditioning
synthesis vs the JAX package (CPU).

The same seeded RGBD items and cameras go to both packages; the port's
draws replay the JAX keys (``JaxReplayNoise``).

Tolerances, and why:
- Camera, blur, presample and postprocess: 1e-6 absolute (the same f32
  elementwise arithmetic; the blur's weights come from a drawn sigma).
- Renders and warps: both resolve fragments of the same lattice and take
  the same dense skirt raster; a pixel may flip only where a sample or a
  pixel centre sits on an edge. At most 1% of mask pixels may differ; color
  and depth within 1e-5 where both masks are set (Lanczos sums and the
  depth linearization in another order).
- The batched synthesis against per-sample synthesis: equal draws, and the
  same raster up to the order of tie sums (1e-6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivid_tpu.data import SyntheticRGBD as JSyntheticRGBD
from ivid_tpu.ops import camera as jcam
from ivid_tpu.ops import geometry as jgeom
from ivid_tpu.ops import image as jim
from ivid_tpu.ops import renderer as jrend
from ivid_tpu.ops import warp as jwarp
from ivid_tpu.training import warp_cond as jwc
from ivid_tpu_torch.ops import camera as tcam
from ivid_tpu_torch.ops import geometry as tgeom
from ivid_tpu_torch.ops import image as tim
from ivid_tpu_torch.ops import renderer as trend
from ivid_tpu_torch.ops import warp as twarp
from ivid_tpu_torch.training import warp_cond as twc

from test_torch_diffusion import JaxReplayNoise

torch.set_num_threads(2)
S = 16
AUGMENTS = ("prewarp_noise", "postwarp_noise", "blur", "erode_rgb")
MASK_FRAC, VALUE_TOL = 1e-2, 1e-5


@functools.lru_cache(maxsize=None)
def _items(n=2):
    ds = JSyntheticRGBD(image_size=S, length=8, prepocess_depth="z_buffer")
    return np.stack([ds[i]["x_0"] for i in range(n)])


def _cams(n=2, seed=0):
    rng = np.random.default_rng(seed)
    eyes = np.stack([[rng.uniform(-0.15, 0.15), rng.uniform(-0.1, 0.1), rng.uniform(0.9, 1.1)]
                     for _ in range(n)]).astype(np.float32)
    centers = rng.uniform(-0.05, 0.05, (n, 3)).astype(np.float32)
    return eyes, centers


def _assert_render_close(got, want):
    m_w = np.asarray(want["mask"]).astype(bool)
    m_g = got["mask"].numpy().astype(bool)
    assert m_w.mean() > 0.1
    assert (m_g != m_w).mean() <= MASK_FRAC
    both = (m_g & m_w)[..., 0]
    for k in ("color", "depth"):
        np.testing.assert_allclose(got[k].numpy()[both], np.asarray(want[k])[both],
                                   atol=VALUE_TOL, rtol=0, err_msg=k)


def test_look_at_and_blur_match_jax():
    eyes, centers = _cams(3)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    got = tcam.look_at(torch.from_numpy(eyes), torch.from_numpy(centers), torch.from_numpy(up))
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(jcam.look_at(eyes[i], centers[i], up)),
                                   atol=1e-6, rtol=0)
    img = np.random.default_rng(1).uniform(size=(9, 7, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jim.gaussian_blur_random_sigma(key, jnp.asarray(img))
    blurred = tim.gaussian_blur_random_sigma(JaxReplayNoise(key), torch.from_numpy(img))
    np.testing.assert_allclose(blurred.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_render_simple_matches_jax():
    x = _items(1)[0]
    eyes, centers = _cams(1, seed=2)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    mv0 = np.asarray(jwarp.default_modelview())
    mv1 = np.asarray(jcam.look_at(eyes[0], centers[0], up))
    depth = x[..., 3:]
    jmesh = jgeom.depth_to_mesh(jgeom.linearize_depth(jnp.asarray(depth)), padding=S,
                                modelview=jnp.asarray(mv0))
    tmesh = tgeom.depth_to_mesh(tgeom.linearize_depth(torch.from_numpy(depth)), padding=S,
                                modelview=torch.from_numpy(mv0))
    want = jrend.render_simple(jmesh, jnp.asarray(x[..., :3]), jnp.asarray(mv1), 45.0, 3 * S,
                               0.1, 200.0, raster_mode="hybrid")
    got = trend.render_simple(tmesh, torch.from_numpy(x[..., :3]), torch.from_numpy(mv1), 45.0,
                              3 * S, 0.1, 200.0)
    assert got["color"].shape == (3 * S, 3 * S, 3)
    _assert_render_close(got, want)


def test_forward_backward_warp_batch_matches_jax():
    x = _items(2)
    eyes, centers = _cams(2, seed=3)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    mv1 = np.stack([np.asarray(jcam.look_at(e, c, up)) for e, c in zip(eyes, centers)])
    want = jwarp.forward_backward_warp_batch(jnp.asarray(x), jnp.asarray(mv1), padding=S)
    got = twarp.forward_backward_warp_batch(torch.from_numpy(x), torch.from_numpy(mv1), padding=S)
    assert got["color"].shape == (2, S, S, 3) and got["mask"].shape == (2, S, S, 1)
    _assert_render_close(got, want)
    single = twarp.forward_backward_warp(torch.from_numpy(x[1]), torch.from_numpy(mv1[1]),
                                         padding=S)
    for k in ("color", "depth", "mask"):
        np.testing.assert_allclose(single[k].numpy(), got[k][1].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_presample_and_postprocess_match_jax(seed):
    x01 = _items(1)[0]
    key = jax.random.PRNGKey(seed)
    j_in, j_mv, j_pose = jwc.presample(jnp.asarray(x01), key, augments=AUGMENTS, pose_std=0.15)
    t_in, t_mv, t_pose = twc.presample(torch.from_numpy(x01), JaxReplayNoise(key),
                                       augments=AUGMENTS, pose_std=0.15)
    for a, b in ((t_in, j_in), (t_mv, j_mv), (t_pose, j_pose)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    rng = np.random.default_rng(seed)
    color = rng.uniform(size=(S, S, 3)).astype(np.float32)
    depth = rng.uniform(size=(S, S, 1)).astype(np.float32)
    mask = (rng.uniform(size=(S, S, 1)) > 0.3).astype(np.float32)
    want = jwc.postprocess(jnp.asarray(x01), key, jnp.asarray(color), jnp.asarray(depth),
                           jnp.asarray(mask), augments=AUGMENTS)
    got = twc.postprocess(torch.from_numpy(x01), JaxReplayNoise(key), torch.from_numpy(color),
                          torch.from_numpy(depth), torch.from_numpy(mask), augments=AUGMENTS)
    assert sorted(got) == sorted(want) == ["mask", "mask_rgb", "y"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, rtol=0,
                                   err_msg=k)


def test_synthesize_single_matches_jax_and_batch():
    x01 = _items(2)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    kw = dict(augments=("prewarp_noise", "blur", "erode_rgb"), pose_std=0.15, near=0.5,
              far=100.0)
    want = jwc.synthesize_single(jnp.asarray(x01[0]), keys[0], **kw)
    got = twc.synthesize_single(torch.from_numpy(x01[0]), JaxReplayNoise(keys[0]), **kw)
    assert sorted(got) == sorted(want) == ["mask", "mask_rgb", "pose", "y"]
    np.testing.assert_allclose(got["pose"].numpy(), np.asarray(want["pose"]), atol=1e-6)
    m_w, m_g = np.asarray(want["mask"]) > 0.5, got["mask"].numpy() > 0.5
    assert m_w.mean() > 0.1 and (m_w != m_g).mean() <= MASK_FRAC
    both = (m_w & m_g)[..., 0]
    np.testing.assert_allclose(got["y"].numpy()[both], np.asarray(want["y"])[both],
                               atol=VALUE_TOL, rtol=0)
    batch = twc.synthesize_batch(torch.from_numpy(x01), [JaxReplayNoise(k) for k in keys], **kw)
    for i in range(2):
        one = twc.synthesize_single(torch.from_numpy(x01[i]), JaxReplayNoise(keys[i]), **kw)
        for k in one:
            np.testing.assert_allclose(batch[k][i].numpy(), one[k].numpy(), atol=1e-6, rtol=0,
                                       err_msg=k)
