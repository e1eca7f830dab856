"""The port's free-view render path vs the JAX package and root ``render.py`` (CPU).

Tolerances and why:
- trajectories and ``orbit_modelview``: 1e-6 (the same f32 look-at in
  another library);
- ``cal_mesh_normal``: 1e-5 (``index_add_`` sums each vertex's face
  contributions in another order than XLA's scatter-add);
- PLY files: byte-equal;
- one render frame (the body of ``render.py:108-121``, JAX under
  ``IVID_TPU_RASTER_MODE=full``): the raw render with the tolerances of
  ``test_torch_aggregation.py`` (masks differ on at most 1% of pixels,
  color and linear depth within 1e-4 where both masks agree); at a pose
  equal to a source view, where grid edges run through pixel centres, at
  most 1% more may differ there (see the test); the 8-bit Lanczos color
  within one 8-bit level on at least 99% of pixels, as the CLI's frames;
- root ``render.py --save_frames`` against ``python -m ivid_tpu_torch.render``
  on one saved scene: PNG frames within one 8-bit level on at least 99% of
  pixels.

The JAX side renders in full mode with ``IVID_TPU_DENSE_MAX_TRIS`` raised:
the port computes the full-mode function at every size, where the JAX
package sends scenes above 100,000 faces (256² SR views) to its per-view
path.
"""

import os
import subprocess
import sys

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivid_tpu.inference import scene_io as jscene
from ivid_tpu.inference import viewsets as jviews
from ivid_tpu.ops import camera as jcam
from ivid_tpu.ops import geometry as jgeom
from ivid_tpu.ops import image as jim
from ivid_tpu.ops import plyio as jply
from ivid_tpu.ops import renderer as jrend
from ivid_tpu_torch import render
from ivid_tpu_torch.inference import scene_io
from ivid_tpu_torch.inference.pipeline import StageClock
from ivid_tpu_torch.inference import viewsets as tviews
from ivid_tpu_torch.ops import camera as tcam
from ivid_tpu_torch.ops import geometry as tgeom
from ivid_tpu_torch.ops import plyio as tply
from ivid_tpu_torch.utils.images import png_decode

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, VIEWS, SSAA = 16, 3, 5


def _depth01(s, seed):
    rng = np.random.default_rng(seed)
    ii = np.linspace(0, 1, s)
    yy, xx = np.meshgrid(ii, ii, indexing="ij")
    d = 0.35 + 0.3 * yy + 0.04 * np.sin(xx * 9 + rng.uniform(0, 6)) + 0.2 * (xx > 0.7)
    return np.clip(d, 0.05, 0.95).astype(np.float32)[..., None]


def write_scene(root, s=S, views=VIEWS, seed=0):
    """A seeded scene of ``views`` views of the 3x9 viewset, saved with the
    port's ``save_scene`` as ``{root}/scenes/scene_seed00000.npz``."""
    rng = np.random.default_rng(seed)
    meshes, colors = [], []
    for v, mv in enumerate(tviews.build_viewset("3x9", 1)[:views]):
        depth = tgeom.linearize_depth(torch.from_numpy(_depth01(s, seed * 100 + v)), 0.6, 5.0)
        mesh = tgeom.depth_to_mesh(depth, padding="frustum", modelview=torch.from_numpy(mv))
        meshes.append(mesh.map(lambda x: x.numpy()))
        colors.append(rng.uniform(0, 1, (s, s, 3)).astype(np.float32))
    os.makedirs(os.path.join(root, "scenes"), exist_ok=True)
    path = os.path.join(root, "scenes", "scene_seed00000.npz")
    scene_io.save_scene(path, meshes, colors)
    return path


def test_trajectories_match():
    got, want = tviews.swing_trajectory(7), jviews.swing_trajectory(7)
    assert len(got) == len(want) == 7
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-6, rtol=0)
    for seed in range(5):
        np.testing.assert_allclose(
            tviews.random_trajectory(np.random.default_rng(seed)),
            jviews.random_trajectory(np.random.default_rng(seed)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("yaw", [-0.6, 0.0, 0.45])
@pytest.mark.parametrize("pitch", [-0.15, 0.0, 0.3])
def test_orbit_modelview_matches(yaw, pitch):
    got = tcam.orbit_modelview(yaw, pitch, radius=1.5, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jcam.orbit_modelview(yaw, pitch, 1.5)),
                               atol=1e-6, rtol=0)


def _mesh_pair(s=12, seed=1):
    mv = np.asarray(jcam.orbit_modelview(0.2, -0.1))
    d = _depth01(s, seed)
    kw = dict(padding="frustum", fov=45.0, atol=0.03, rtol=0.03, erode_rgb=3)
    j = jgeom.depth_to_mesh(jgeom.linearize_depth(jnp.asarray(d), 0.6, 5.0),
                            modelview=jnp.asarray(mv), **kw)
    t = tgeom.depth_to_mesh(tgeom.linearize_depth(torch.from_numpy(d), 0.6, 5.0),
                            modelview=torch.from_numpy(mv.copy()), **kw)
    return j, t


def test_cal_mesh_normal_matches():
    j, t = _mesh_pair()
    want = np.asarray(jgeom.cal_mesh_normal(j.positions, j.faces))
    got = tgeom.cal_mesh_normal(t.positions, t.faces).numpy()
    assert got.shape == want.shape == (14 * 14, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("writer", ["save_ply", "mesh_to_ply"])
def test_ply_files_are_byte_equal(tmp_path, writer):
    """Both writers on the same mesh (the JAX mesh's arrays; the port's
    writer is given tensors) write the same bytes."""
    j, _ = _mesh_pair()
    t = tgeom.Mesh(**{f: None if getattr(j, f) is None else torch.from_numpy(np.array(getattr(j, f)))
                      for f in ("positions", "uv", "flag", "normal", "faces", "depth",
                                "modelview")})
    rng = np.random.default_rng(2)
    if writer == "save_ply":
        colors = rng.uniform(-0.1, 1.1, (len(t.positions), 3)).astype(np.float32)
        tply.save_ply(str(tmp_path / "t.ply"), t.positions, torch.from_numpy(colors), t.faces)
        jply.save_ply(str(tmp_path / "j.ply"), j.positions, colors, j.faces)
    else:
        img = rng.uniform(0, 1, (12, 12, 3)).astype(np.float32)
        tply.mesh_to_ply(str(tmp_path / "t.ply"), t, torch.from_numpy(img))
        jply.mesh_to_ply(str(tmp_path / "j.ply"), j, img)
    got, want = (tmp_path / "t.ply").read_bytes(), (tmp_path / "j.ply").read_bytes()
    assert got.startswith(b"ply\nformat binary_little_endian 1.0\n") and len(got) > 1000
    assert got == want


@pytest.mark.parametrize("pose", ["between views", "on a view"])
def test_render_frame_matches_jax(tmp_path, monkeypatch, pose):
    """One frame of the CLI at s = 16, SSAA 5 (r = 80), the JAX side padded
    to 5 slots with invalid ones as its CLI pads to 27. "on a view" is the
    swing pose that equals the scene's second camera (yaw 0, pitch 0.15):
    that view's grid vertices then project onto pixel centres, its
    triangle edges run through them, and the two rasters' f32 roundings
    decide those ties apart (measured: 0.30% of the r = 80 pixels differ
    where the masks agree, also with both given the same meshes; after the
    5x Lanczos resize they move 7.8% of the 16² pixels by more than one
    8-bit level). Between views there are no such ties (measured: none)."""
    monkeypatch.setenv("IVID_TPU_RASTER_MODE", "full")
    monkeypatch.setenv("IVID_TPU_DENSE_MAX_TRIS", str(10 ** 7))
    path = write_scene(str(tmp_path))
    jm, jc = jscene.load_scene(path)
    tm, tc = scene_io.load_scene(path, device="cpu")
    pad = 2
    zero = jax.tree.map(jnp.zeros_like, jm[0])
    stacked = jrend.stack_meshes(jm + [zero] * pad)
    col = jnp.asarray(np.stack(jc + [np.zeros_like(jc[0])] * pad))
    valid = jnp.asarray([True] * VIEWS + [False] * pad)
    mv = tviews.swing_trajectory(7)[2] if pose == "between views" else tviews.swing_trajectory(5)[1]
    want = jrend.render_aggregation(stacked, col, valid, jnp.asarray(mv), fov=45.0,
                                    render_size=S * SSAA, near=0.1, far=200.0,
                                    interior_level=SSAA + 1)
    want_color = np.asarray(jim.resize_lanczos_8bit(want["color"], S))
    want_depth = np.asarray(jim.ssaa_subsample(want["depth"], SSAA))

    from ivid_tpu_torch.ops import image as tim
    from ivid_tpu_torch.ops import renderer as trend

    meshes, colors = tgeom.stack_meshes(tm), torch.from_numpy(np.stack(tc))
    raw = trend.render_aggregation(meshes, colors, torch.from_numpy(mv), fov=45.0,
                                   render_size=S * SSAA, near=0.1, far=200.0)
    want = {k: np.asarray(v) for k, v in want.items()}
    raw_t, raw = raw, {k: v.numpy() for k, v in raw.items()}
    assert want["mask_depth"].mean() > 0.3
    for k in ("mask_color", "mask_depth"):
        assert (raw[k] != want[k]).mean() <= 0.01, k
    agree = (raw["mask_color"] == want["mask_color"]) & (raw["mask_depth"] == want["mask_depth"])
    off = agree[..., 0] & ((np.abs(raw["color"] - want["color"]).max(-1) > 1e-4)
                           | (np.abs(raw["depth"] - want["depth"])[..., 0] > 1e-4))
    assert off.mean() <= (0.0 if pose == "between views" else 0.01)
    close = agree & ~off[..., None]
    for k in ("color", "depth"):
        a = np.broadcast_to(close, raw[k].shape)
        np.testing.assert_allclose(raw[k][a], want[k][a], atol=1e-4, rtol=1e-4, err_msg=k)

    color, depth = render.render_frame(meshes, colors, torch.from_numpy(mv), SSAA,
                                       StageClock(torch.device("cpu"), "render"))
    color, depth = color.numpy(), depth.numpy()
    assert color.shape == (S, S, 3) and depth.shape == (S, S, 1)
    np.testing.assert_array_equal(color, tim.resize_lanczos_8bit(raw_t["color"], S).numpy())
    one_level = np.abs(color - want_color).max(-1) <= 1.0 / 255 + 1e-6
    if pose == "between views":
        assert one_level.mean() >= 0.99
    else:  # the resize itself on the same input: one 8-bit level on 99% of pixels
        same_input = np.asarray(jim.resize_lanczos_8bit(jnp.asarray(raw["color"]), S))
        assert (np.abs(color - same_input).max(-1) <= 1.0 / 255 + 1e-6).mean() >= 0.99
    sub = close[SSAA // 2::SSAA, SSAA // 2::SSAA]
    np.testing.assert_allclose(depth[sub], want_depth[sub], atol=1e-4, rtol=1e-4)


def test_render_cli_frames_match_root_cli(tmp_path):
    """``python -m ivid_tpu_torch.render --device cpu --save_frames`` and root
    ``render.py --save_frames`` (JAX on the CPU, full raster mode) on one
    saved scene, 3 swing frames."""
    scene_dir = str(tmp_path / "scene")
    write_scene(scene_dir)
    env = dict(os.environ, IVID_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu",
               IVID_TPU_RASTER_MODE="full", IVID_TPU_DENSE_MAX_TRIS=str(10 ** 7),
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "render.py"), "--scene_dir",
                           scene_dir, "--output_dir", str(tmp_path / "jax"), "--frames", "3",
                           "--save_frames"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = render.main(["--scene_dir", scene_dir, "--output_dir", str(tmp_path / "torch"),
                       "--frames", "3", "--save_frames", "--device", "cpu"])
    assert res["n_frames"] == 3 and res["stage_ms"] == {}
    color, depth = res["frames"]["scene_seed00000"]
    assert color.shape == depth.shape == (3, S, S, 3) and color.dtype == np.uint8
    for k in range(3):
        want = imageio.imread(tmp_path / "jax" / "videos" / "scene_seed00000" / f"{k:03d}.png")
        with open(tmp_path / "torch" / "videos" / "scene_seed00000" / f"{k:03d}.png", "rb") as f:
            got = png_decode(f.read())
        np.testing.assert_array_equal(got, color[k])
        diff = np.abs(got.astype(int) - want.astype(int))
        assert got.shape == want.shape == (S, S, 3)
        assert diff.max() <= 1 or (diff > 1).mean() <= 0.01
        assert (diff <= 1).mean() >= 0.99
    assert (tmp_path / "torch" / "videos" / "scene_seed00000.mp4").exists()
    assert (tmp_path / "torch" / "videos" / "scene_seed00000_depth.mp4").exists()


def test_render_random_pose_writes_result_png(tmp_path):
    write_scene(str(tmp_path))
    res = render.main(["--scene_dir", str(tmp_path), "--traj", "random", "--ssaa", "2",
                       "--device", "cpu"])
    assert res["n_frames"] == 1
    with open(tmp_path / "results" / "scene_seed00000.png", "rb") as f:
        np.testing.assert_array_equal(png_decode(f.read()), res["frames"]["scene_seed00000"][0][0])


def test_png_writer_without_cv2_and_imageio(tmp_path, monkeypatch, capsys):
    """With neither video library importable, swing frames go to PNG files
    in ``videos/{name}/`` and ``videos/{name}_depth/``, and a note says so."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    write_scene(str(tmp_path))
    res = render.main(["--scene_dir", str(tmp_path), "--frames", "2", "--ssaa", "2",
                       "--device", "cpu"])
    assert "PNG frames" in capsys.readouterr().out
    videos = tmp_path / "videos"
    assert sorted(p.name for p in videos.iterdir()) == ["scene_seed00000",
                                                        "scene_seed00000_depth"]
    color, depth = res["frames"]["scene_seed00000"]
    for sub, want in (("scene_seed00000", color), ("scene_seed00000_depth", depth)):
        names = sorted(p.name for p in (videos / sub).iterdir())
        assert names == ["000.png", "001.png"]
        for k, n in enumerate(names):
            np.testing.assert_array_equal(png_decode((videos / sub / n).read_bytes()), want[k])


def test_render_cli_needs_the_card_by_default(tmp_path):
    """Without ``--device`` the CLI runs on ``cuda``: with no card it raises
    before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    write_scene(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render.main(["--scene_dir", str(tmp_path)])
    assert not (tmp_path / "videos").exists()
