"""The port's SR entry (``ivid_tpu_torch.sr.upsample_views``) and its basic
trainer against the benchmark's plain reference (``port_bench/reference/
sr.py`` and ``train_basic.py``), on the CPU in f32, with the benchmark's
seeded weights (``port_bench.weights``: every layer reaches the output) and
noise sources.

Tolerances, and why:
- ``upsample_views`` against the reference, 1e-4 worst view relative L2:
  two f32 UNets that agree to ~1e-6 a forward (the port's bilinear
  upsample as two resampling products, the reference's ``F.interpolate``;
  the same layers otherwise), through 3 guided DDIM steps, where guidance
  3 scales the gap of each forward by up to 7 (as ``test_torch_sr``'s
  sampling chains).
- Chunks of 2 against one chunk of 5, 1e-5: each row is computed alone, so
  only the CPU convolutions' blocking for another batch size moves it (f32
  rounding, ~1e-7 a forward, scaled by guidance through 3 steps: 1.2e-6
  read); a chunk's wrong rows or order moves the views by O(1).
- ``sr.main`` against ``upsample_views``: bit for bit, the same function on
  the same views, weights and noise.
- A dropped condition must read above the first tolerance by far (it moves
  the views by O(1)).
- ``BasicTrainer``'s first 2 steps against the reference: the gaps of the
  first gradient's norm, and of the changes of the parameters and of the
  EMA by leaf (``port_bench/drivers/train.py:readings``), 1e-5, and each
  step's loss 1e-6 relative: the same f32 arithmetic in another order.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from ivid_tpu_torch import sr
from ivid_tpu_torch.config import Config, build_backbone, build_framework_from_config
from ivid_tpu_torch.diffusion.noise import TorchNoise
from ivid_tpu_torch.inference.scene_io import load_scene, save_scene
from ivid_tpu_torch.ops import geometry as geom
from ivid_tpu_torch.utils.images import png_encode, to8b
from port_bench import sr_faults, weights
from port_bench.drivers import train
from port_bench.drivers import train_basic
from port_bench.noise import Noise
from port_bench.reference import sr as ref_sr
from port_bench.reference.unet import build_unet

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# The SR config's kind of UNet at 32² from 16², narrow: 8 inputs, classes
# with a null class, attention at 16².
SR_ARGS = dict(image_size=32, in_channels=8, out_channels=4, model_channels=16,
               num_res_blocks=1, num_classes=3, has_null_class=True, channel_mult=[1, 2],
               attention_resolutions=[16], num_groups=8, num_heads=None,
               num_head_channels=16, dropout=0.0, use_fp16=False)
SR_FW = {"name": "SuperResCFG", "args": {"timesteps": 100, "beta_schedule": "linear",
                                         "p_uncond": 0.1}}
STEPS, GUIDANCE, CLASS = 3, 3.0, 2


def rel(got, want):
    """The worst view's relative L2 distance."""
    d = (got.double() - want.double()).flatten(1).norm(dim=1)
    return float((d / want.double().flatten(1).norm(dim=1)).max())


def sr_pair(seed=3):
    """The port's SR framework and the reference's, on the same weights."""
    cfg = Config(backbone={"name": "AdmUnet2d", "args": SR_ARGS}, framework=SR_FW)
    model = build_backbone(cfg).eval()
    w = weights.draw(SR_ARGS, seed, "sr", CPU)
    weights.load(model, w)
    unet = build_unet(SR_ARGS).eval()
    weights.load(unet, w)
    return (build_framework_from_config(cfg, model, device=CPU),
            ref_sr.SuperResFramework(unet, SR_FW["args"], CPU))


def views(n=5, seed=0):
    """Low-resolution RGBD views in [0, 1]."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 16, 16, 4), generator=g)


def port_views(fw, v, noise, batchsize, classes=CLASS):
    return sr.upsample_views(fw, v, classes=classes, noise=noise, steps=STEPS,
                             guidance=GUIDANCE, batchsize=batchsize, image_size=32)


def ref_views(fw, v, noise, batchsize, classes=CLASS):
    return ref_sr.upsample_views(fw, v, classes=classes, noise=noise, steps=STEPS,
                                 guidance=GUIDANCE, batchsize=batchsize, image_size=32, block=2)


@pytest.mark.parametrize("batchsize,classes", [(5, CLASS), (2, CLASS), (3, None)],
                         ids=["one chunk", "chunks of 2", "no class"])
def test_upsample_views_matches_the_reference(batchsize, classes):
    """Guided DDIM with classes (CFG over one forward of the class and the
    null class), in one chunk and in chunks; without a class, unguided.
    The reference computes each chunk 2 views at a time."""
    port, ref = sr_pair()
    v = views()
    noise = Noise.seeded(2 ** 31 + 5, "scene", 0).fold_in
    got = port_views(port, v, noise, batchsize, classes)
    want = ref_views(ref, v, noise, batchsize, classes)
    assert got.shape == want.shape == (5, 32, 32, 4)
    assert float(want.std()) > 0.1
    assert rel(got, want) < 1e-4


class SlicedNoise:
    """A noise source whose draws are rows ``start …`` of ``full``: a chunk
    that starts at view ``start`` draws its views' rows of one x_T."""

    def __init__(self, full, start):
        self.full, self.start = full, start

    def split(self, num=2):
        return (self,) * num

    def fold_in(self, i):
        return self

    def normal(self, shape):
        return self.full[self.start:self.start + shape[0]]


def test_chunks_give_what_one_chunk_gives():
    """``batchsize`` smaller than the views: chunks of 2, 2 and 1 from the
    same rows of x_T give the views one chunk of 5 gives."""
    port, _ = sr_pair()
    v = views(seed=1)
    full = torch.randn((5, 32, 32, 4), generator=torch.Generator().manual_seed(4))
    whole = port_views(port, v, lambda i: SlicedNoise(full, i), 5)
    chunked = port_views(port, v, lambda i: SlicedNoise(full, i), 2)
    assert rel(chunked, whole) < 1e-5


def test_dropped_condition_is_seen(monkeypatch):
    """The benchmark's planted fault (the views zeroed before they are
    packed) moves the reading far past the tolerance."""
    port, ref = sr_pair()
    v = views()
    noise = Noise.seeded(7, "scene", 0).fold_in
    want = ref_views(ref, v, noise, 5)
    sr_faults.condition_dropped(monkeypatch.setattr)
    assert rel(port_views(port, v, noise, 5), want) > 100 * 1e-4


def _write_scene(tmp_path, name, n=3):
    rng = np.random.default_rng(0)
    meshes, colors = [], []
    for _ in range(n):
        rgbd = rng.uniform(0.2, 0.8, size=(16, 16, 4)).astype(np.float32)
        meshes.append(geom.depth_to_mesh(
            geom.linearize_depth(torch.from_numpy(rgbd[..., 3:]), 0.6, 5.0), padding="frustum",
            fov=45.0, modelview=torch.eye(4), atol=0.03, rtol=0.03, erode_rgb=3,
            cal_normal=True).map(lambda x: x.numpy()))
        colors.append(rgbd[..., :3])
    os.makedirs(tmp_path / "scenes", exist_ok=True)
    save_scene(str(tmp_path / "scenes" / f"{name}.npz"), meshes, colors)


def test_sr_main_writes_what_upsample_views_returns(tmp_path):
    """``sr.main`` on a saved 3-view scene in chunks of 2: its views and its
    PNG are ``upsample_views``' on the views ``load_scene`` and
    ``project_depth`` give, with the CLI's weights and noise."""
    name = "scene_seed00004"
    _write_scene(tmp_path, name)
    cfg_path = tmp_path / "sr.json"
    cfg_path.write_text(json.dumps({"backbone": {"name": "AdmUnet2d", "args": SR_ARGS},
                                    "framework": SR_FW}))
    result = sr.main(["--config_sr", str(cfg_path), "--ckpt_sr", "random", "--scene_dir",
                      str(tmp_path), "--steps", str(STEPS), "--batchsize", "2",
                      "--device", "cpu"])
    from ivid_tpu_torch.sample import build_model

    fw = build_model(Config.load(str(cfg_path)), "random", 0, CPU)
    meshes, colors = load_scene(str(tmp_path / "scenes" / f"{name}.npz"), device="cpu")
    v = torch.stack([torch.cat([torch.from_numpy(c), geom.project_depth(m.depth, 0.6, 5.0)],
                               dim=-1) for m, c in zip(meshes, colors)])
    want = port_views(fw, v, lambda i: TorchNoise.seeded(i), 2, classes=4 % 3).numpy()
    got = result["samples"][0]
    assert got.shape == (3, 32, 32, 4) and np.array_equal(got, want)
    png = (tmp_path / "results_sr" / f"{name}.png").read_bytes()
    assert png == png_encode(to8b(want[0, ..., :3]))


def tiny_in128():
    """The in128 benchmark configuration cut to a 16² UNet of two levels
    with 10 classes (every width a tiny one)."""
    with open(os.path.join(ROOT, "port_bench", "configs", "in128.json")) as f:
        cfg = copy.deepcopy(json.load(f))
    model = cfg["models"]["uncond"]
    model["backbone"]["args"].update(image_size=16, model_channels=32, channel_mult=[1, 2],
                                     attention_resolutions=[8], num_res_blocks=1,
                                     num_classes=10)
    model["dataset"]["args"]["image_size"] = 16
    return cfg


def test_basic_trainer_first_steps_match_the_reference(tmp_path):
    """``BasicTrainer.run_step`` twice (f32, CFG's label drop, AdamW, EMA;
    the trainer's own loader over labelled procedural images) against
    ``reference/train_basic.py`` from the same weights, rows, labels and
    noise."""
    cfg = tiny_in128()
    traffic = {"batch": 4, "dataset": {"length": 8, "blobs": 3}, "num_workers": 1,
               "worker_mode": "thread", "check_steps": 2}
    seed = 2 ** 31 + 9
    prog = train_basic.Program(cfg, traffic, seed, CPU, str(tmp_path))
    try:
        got = prog.first_steps(2)
    finally:
        prog.close()
    ref = train_basic.reference_steps(cfg, traffic, seed, CPU)
    readings = train.readings(got, ref)
    assert all(v < 1e-5 for v in readings.values()), readings
    assert len(got["losses"]) == len(ref["losses"]) == 2
    for a, b in zip(got["losses"], ref["losses"]):
        assert abs(a - b) <= 1e-6 * abs(b)
    assert all(g > 0 for g in ref["grad0"].values() if g is not None)
