"""The port's whole sampling chain vs ``ivid_tpu.inference.ScenePipeline`` (CPU).

A 2-view, batch-1 scene on a tiny UNet pair (T=100; 10-step DDIM for the
first view, 5-step guided DDIM for the second), the same random weights on
both sides, JAX under ``IVID_TPU_RASTER_MODE=full`` and the port's noise source
replaying the JAX keys. Both views, and the second view's condition color,
within 1e-4 relative L2 (measured ~1e-6: the two f32 UNets and rasters agree
to rounding); condition masks may differ on at most 1% of pixels, since a
pixel-centre tie on a mesh edge could flip one (measured: none).

Also: the sampling CLI end to end on the CPU (records, scene npz, a reference
state-dict checkpoint), the scene npz layout against the JAX package's
``save_scene``, and that importing the port pulls in no JAX.
"""

import io
import json
import os
import subprocess
import sys

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import torch

from ivid_tpu.diffusion import build_framework as jax_framework
from ivid_tpu.inference import ScenePipeline as JaxPipeline
from ivid_tpu.inference.scene_io import save_scene as jax_save_scene
from ivid_tpu.inference.viewsets import build_viewset
from ivid_tpu_torch import sample
from ivid_tpu_torch.diffusion.frameworks import build_framework as torch_framework
from ivid_tpu_torch.inference.pipeline import ScenePipeline
from ivid_tpu_torch.inference.scene_io import save_scene
from ivid_tpu_torch.models import adm

from test_torch_diffusion import JaxReplayNoise, model_pair

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE = dict(
    image_size=16, in_channels=4, out_channels=4, model_channels=16,
    num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[8],
    num_groups=8, num_heads=None, num_head_channels=16, num_classes=None,
    has_null_class=False, dropout=0.0, use_fp16=False,
)
FW_U = {"timesteps": 100, "beta_schedule": "linear"}
FW_C = {**FW_U, "p_uncond": 0.1, "p_uncond_img": 0}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def smooth_first_view_noise(schedule_acp_last):
    """x_T that a near-zero-eps DDIM chain carries to a smooth RGBD view (so
    its mesh has few discontinuities and the second view is well
    conditioned): eta=0 DDIM with eps = 0 scales x_T by 1/sqrt(acp[T-1])."""
    ii = np.linspace(0, 1, 16)
    yy, xx = np.meshgrid(ii, ii, indexing="ij")
    rgb = np.stack([0.5 * np.sin(3 * xx + c) * np.cos(2 * yy) for c in range(3)], -1)
    depth = (0.45 + 0.05 * yy + 0.01 * np.sin(4 * xx))[..., None] * 2 - 1
    x0 = np.concatenate([rgb, depth], -1)[None].astype(np.float32)
    return x0 * np.sqrt(schedule_acp_last).astype(np.float32)


def _run_both(views, batch, steps_cond, max_agg_views=None):
    """The same scene through the JAX and the port pipelines."""
    # First-view model: every leaf random, the output convolution scaled to
    # 1e-5 so its small eps perturbs (and exercises) a smooth first view
    # (eps is amplified by 1/sqrt(acp[T-1]) ~ 160 on the way to x_0).
    pu, ju, params_u = model_pair(BACKBONE, seed=0, out_scale=1e-5)
    pc, jc, params_c = model_pair(dict(BACKBONE, in_channels=10), seed=1)
    kw = dict(image_size=16, steps_uncond=10, steps_cond=steps_cond, guidance=0.0,
              max_agg_views=max_agg_views)
    fwu = torch_framework("GaussianDiffusion", pu, FW_U)
    jpipe = JaxPipeline(jax_framework("GaussianDiffusion", ju, FW_U),
                        jax_framework("InpaintCFG", jc, FW_C), max_views=4, **kw)
    tpipe = ScenePipeline(fwu, torch_framework("InpaintCFG", pc, FW_C), **kw)
    noise = np.repeat(smooth_first_view_noise(fwu.schedule.alphas_cumprod[-1].item()),
                      batch, axis=0)
    key = jax.random.PRNGKey(3)
    _, j_samples, j_conds = jpipe.sample_batch(params_u, params_c, key, views, batch=batch,
                                               noise=jnp.asarray(noise))
    state, t_samples, t_conds = tpipe.sample_batch(JaxReplayNoise(key), views, batch=batch,
                                                   noise=torch.from_numpy(noise))
    j_conds = {k: np.asarray(v) for k, v in j_conds.items()}
    t_conds = {k: v.numpy() for k, v in t_conds.items()}
    return np.asarray(j_samples), j_conds, t_samples.numpy(), t_conds, state


def _check_views(j_samples, j_conds, t_samples, t_conds):
    assert t_samples.shape == j_samples.shape
    assert np.isfinite(t_samples).all()
    assert rel(t_samples[:, 0], j_samples[:, 0]) < 1e-4
    j_mask = j_conds["depth"] > -1  # depth*2-1 is -1 exactly off the mask
    t_mask = t_conds["depth"] > -1
    assert j_mask.mean() > 0.2
    assert (j_mask != t_mask).mean() <= 0.01
    assert rel(t_conds["color"], j_conds["color"]) < 1e-4
    assert rel(t_samples[:, 1:], j_samples[:, 1:]) < 1e-4


def test_two_view_chain_matches_jax_pipeline(monkeypatch):
    monkeypatch.setenv("IVID_TPU_RASTER_MODE", "full")
    views = np.stack([build_viewset("uncond", 1)[0],
                      np.asarray(build_viewset("3x9", 1)[3])])
    j_samples, j_conds, t_samples, t_conds, state = _run_both(views, 1, steps_cond=5)
    assert t_samples.shape == (1, 2, 16, 16, 4)
    _check_views(j_samples, j_conds, t_samples, t_conds)
    assert len(state.meshes) == 2 and state.meshes[1].positions.shape == (1, 18 * 18, 3)


def test_nearest_view_cap_matches_jax_pipeline(monkeypatch):
    """``max_agg_views=1`` with per-sample viewsets: the third view of each
    sample is conditioned on its own angularly nearest earlier view."""
    monkeypatch.setenv("IVID_TPU_RASTER_MODE", "full")
    grid = build_viewset("3x9", 1)
    canonical = build_viewset("uncond", 1)[0]
    views = np.stack([np.stack([canonical, grid[3], grid[5]]),
                      np.stack([canonical, grid[6], grid[2]])])
    j_samples, j_conds, t_samples, t_conds, _ = _run_both(views, 2, steps_cond=2,
                                                          max_agg_views=1)
    assert t_samples.shape == (2, 3, 16, 16, 4)
    _check_views(j_samples, j_conds, t_samples, t_conds)


def test_scene_npz_layout_matches_jax(tmp_path):
    """Same meshes and colors through both ``save_scene``s: the same records,
    PNG payloads that decode to the same pixels."""
    pu = adm.build_adm_unet(BACKBONE)
    pipe = ScenePipeline(torch_framework("GaussianDiffusion", pu, FW_U), image_size=16,
                         steps_uncond=2)
    rgbd01 = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 16, 16, 4))
                              .astype(np.float32))
    mesh = pipe._make_meshes(rgbd01, torch.eye(4)[None])
    meshes = [mesh.map(lambda x: x[0].numpy())]
    colors = [rgbd01[0, ..., :3].numpy()]
    save_scene(str(tmp_path / "port.npz"), meshes, colors)
    jax_save_scene(str(tmp_path / "jax.npz"), meshes, colors)
    got = np.load(tmp_path / "port.npz", allow_pickle=True)["data"]
    want = np.load(tmp_path / "jax.npz", allow_pickle=True)["data"]
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["fov"] == w["fov"]
        np.testing.assert_array_equal(g["modelview"], w["modelview"])
        for k in ("color", "depth"):
            np.testing.assert_array_equal(imageio.imread(io.BytesIO(g[k])),
                                          imageio.imread(io.BytesIO(w[k])))


def test_sample_cli_writes_every_record(tmp_path):
    cfg = {"backbone": {"name": "AdmUnet2d", "args": BACKBONE},
           "framework": {"name": "GaussianDiffusion", "args": FW_U}}
    cond = {"backbone": {"name": "AdmUnet2d", "args": dict(BACKBONE, in_channels=10)},
            "framework": {"name": "InpaintCFG", "args": FW_C}}
    for name, c in (("u.json", cfg), ("c.json", cond)):
        (tmp_path / name).write_text(json.dumps(c))
    ckpt = adm.randomize_parameters(adm.build_adm_unet(BACKBONE), seed=9)
    torch.save(ckpt.state_dict(), tmp_path / "u.pt")
    result = sample.main([
        "--config_uncond", str(tmp_path / "u.json"), "--config_cond", str(tmp_path / "c.json"),
        "--ckpt_uncond", str(tmp_path / "u.pt"), "--ckpt_cond", "random",
        "--output_dir", str(tmp_path / "out"), "--seeds", "0-2", "--viewset", "random",
        "--batchsize", "2", "--steps_uncond", "4", "--steps_cond", "2", "--device", "cpu",
    ])
    out = result["output_dir"]
    assert out.endswith("viewset_random_steps_u4_c2_guidance3.0")
    assert [s.shape for s in result["samples"]] == [(2, 2, 16, 16, 4), (1, 2, 16, 16, 4)]
    assert all(np.isfinite(s).all() for s in result["samples"])
    names = {sub: sorted(os.listdir(os.path.join(out, sub)))
             for sub in ("scenes", "conds", "grids", "results")}
    seeds = [f"seed{i:05d}" for i in range(3)]
    assert names["scenes"] == [f"scene_{s}.npz" for s in seeds]
    for sub in ("conds", "grids", "results"):
        assert names[sub] == [f"rgb_{s}.png" for s in seeds]
    grid = imageio.imread(os.path.join(out, "grids", "rgb_seed00000.png"))
    assert grid.shape == (20, 38, 3)
    data = np.load(os.path.join(out, "scenes", "scene_seed00002.npz"), allow_pickle=True)["data"]
    assert len(data) == 2
    assert imageio.imread(io.BytesIO(data[1]["color"])).shape == (16, 16, 3)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ivid_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(ivid_tpu_torch.__path__, 'ivid_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ivid_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'ivid_tpu_torch.sample' in sys.modules\n"
        "assert 'ivid_tpu_torch.bench_resolve' in sys.modules\n"
        "assert 'ivid_tpu_torch.bench_micro' in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
