"""The port's SR cascade vs the JAX package (CPU, f32): ``SuperResCFG``,
``SyntheticRGBDSR``, ``gaussian_blur``, ``finetune_load``, the trainers'
channel-pad finetune, ``SuperResTrainer`` and ``python -m ivid_tpu_torch.sr``.

Weights are made on the JAX side (a flax init with every leaf redrawn from a
numpy seed) and carried to the port by ``models.convert.flax_to_state_dict``,
on an SR-shaped tree: 8 input channels, five levels, classes with a null
class. Noise is replayed from the JAX keys (``JaxReplayNoise``).

Tolerances, and why:
- ``pack_inputs`` 1e-6: the same resampling weights in f32, contracted in
  another order.
- ``gaussian_blur`` 1e-6, the SR items exactly: the same f32 or numpy code.
- The UNet 1e-5 relative L2, the loss 1e-5 relative, gradients 1e-4 relative
  L2 per tensor, sampling chains 1e-4 relative L2: two f32 UNets that agree
  to ~1e-6 per call (as ``test_torch_training``/``test_torch_diffusion``).
- ``finetune_load`` exactly: both copy the same f32 values and add zeros.
- The trainer step: as ``test_torch_training.test_trainer_step_with_ema_matches_jax``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivid_tpu.data import SyntheticRGBDSR as JSyntheticRGBDSR
from ivid_tpu.diffusion import build_framework as jax_framework
from ivid_tpu.diffusion import samplers as jsamp
from ivid_tpu.inference.scene_io import load_scene as jax_load_scene
from ivid_tpu.inference.scene_io import save_scene as jax_save_scene
from ivid_tpu.models import build_adm_unet as jax_build
from ivid_tpu.models.torch_compat import torch_state_dict_to_flax
from ivid_tpu.ops import camera as jcam
from ivid_tpu.ops import geometry as jgeom
from ivid_tpu.ops import image as jimage
from ivid_tpu.training import checkpoint as jckpt
from ivid_tpu.training.trainer import SuperResTrainer as JSuperResTrainer
from ivid_tpu_torch import sr
from ivid_tpu_torch.data import DATASETS, SRDataset, SyntheticRGBDSR
from ivid_tpu_torch.diffusion import samplers as tsamp
from ivid_tpu_torch.diffusion.frameworks import build_framework as torch_framework
from ivid_tpu_torch.inference.scene_io import load_scene
from ivid_tpu_torch.models import adm
from ivid_tpu_torch.models.convert import flax_to_state_dict
from ivid_tpu_torch.ops import image as timage
from ivid_tpu_torch.training import checkpoint as ckpt_io
from ivid_tpu_torch.training.trainer import TRAINERS, InpaintTrainer, SuperResTrainer

from test_torch_diffusion import JaxReplayNoise

torch.set_num_threads(2)

# The SR config's shape at 32² (five levels, attention at the three
# coarsest, 8 inputs, classes with a null class), narrow.
SR = dict(
    image_size=32, in_channels=8, out_channels=4, model_channels=16, num_res_blocks=1,
    channel_mult=[1, 1, 2, 3, 4], attention_resolutions=[8, 4, 2], num_groups=8,
    num_heads=None, num_head_channels=16, num_classes=3, has_null_class=True, dropout=0.0,
    use_fp16=False,
)
# Two levels of the same, for the tests that compile JAX train steps and
# samplers (the five-level graph is slow to compile on the CPU).
SMALL = dict(SR, channel_mult=[1, 2], attention_resolutions=[16])
ARCH_KEYS = ["image_size", "model_channels", "num_res_blocks", "channel_mult",
             "attention_resolutions", "num_classes"]
FW = {"timesteps": 100, "beta_schedule": "linear", "p_uncond": 0.5}
DATA = dict(image_size=32, image_size_lr=16, length=16, num_classes=3, normalize=True,
            normalize_depth=True, prepocess_depth="z_buffer")


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def random_flax(cfg, seed):
    """A flax init of ``cfg`` with every leaf redrawn from numpy seed
    ``seed``: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), biases
    N(0, 0.02²), class embeddings N(0, 1)."""
    s, c = cfg["image_size"], cfg["in_channels"]
    init = jax.eval_shape(jax_build(cfg, dtype=jnp.float32).init,
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, c)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32) if cfg["num_classes"] else None)["params"]
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(init)
    out = []
    for path, leaf in leaves:
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(leaf.shape)
        if name.endswith("['scale']"):
            v = 1.0 + 0.1 * z
        elif name.endswith("['bias']"):
            v = 0.02 * z
        elif "label_emb" in name:
            v = z
        else:
            v = z / np.sqrt(np.prod(leaf.shape[:-1]))
        out.append(jnp.asarray(v.astype(np.float32)))
    return jax.tree_util.tree_unflatten(tree, out)


def sr_pair(cfg=SR, seed=0):
    """(port UNet, flax module, flax params) with the same weights, carried
    from the flax tree by ``flax_to_state_dict``."""
    params = random_flax(cfg, seed)
    port = adm.build_adm_unet(cfg, dtype=torch.float32)
    port.load_state_dict(flax_to_state_dict(jax.device_get(params), **cfg))
    return port.eval(), jax_build(cfg, dtype=jnp.float32), params


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _to_flax(sd, cfg=SR):
    return _flat(torch_state_dict_to_flax(
        {k: v.detach().float().numpy().copy() for k, v in sd.items()},
        **{k: cfg[k] for k in ARCH_KEYS}))


def _sr_batch(n):
    ds = SyntheticRGBDSR(**DATA)
    items = [ds[i] for i in range(n)]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


@pytest.mark.parametrize("lo,hi", [(16, 32), (32, 48), (12, 40)], ids=["2x", "1.5x", "10/3x"])
def test_pack_inputs_matches_jax(lo, hi):
    """The upsampled condition, border included, at 2x and at other ratios;
    the packing puts it after x_t."""
    rng = np.random.default_rng(lo)
    x = rng.standard_normal((2, hi, hi, 4)).astype(np.float32)
    y = rng.standard_normal((2, lo, lo, 4)).astype(np.float32)
    jfw = jax_framework("SuperResCFG", None, FW)
    tfw = torch_framework("SuperResCFG", None, FW)
    want = np.asarray(jfw.pack_inputs(None, jnp.asarray(x), {"y": jnp.asarray(y)}))
    got = tfw.pack_inputs(None, torch.from_numpy(x), {"y": torch.from_numpy(y)}).numpy()
    assert got.shape == want.shape == (2, hi, hi, 8)
    np.testing.assert_array_equal(got[..., :4], x)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_resize_bilinear_border_and_downsampling_match_jax():
    """``resize_bilinear`` is ``jax.image.resize(method="bilinear")`` also
    where ``F.interpolate`` is not: downsampling (antialiased) and a
    non-square resize."""
    y = np.random.default_rng(1).standard_normal((1, 24, 20, 3)).astype(np.float32)
    for h, w in ((12, 10), (7, 30), (48, 40)):
        want = np.asarray(jax.image.resize(jnp.asarray(y), (1, h, w, 3), method="bilinear"))
        got = timage.resize_bilinear(torch.from_numpy(y), h, w).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("sigma,size", [(0.3, 3), (1.0, 3), (2.0, 5)])
def test_gaussian_blur_matches_jax(sigma, size):
    x = np.random.default_rng(4).standard_normal((13, 9, 4)).astype(np.float32)
    want = np.asarray(jimage.gaussian_blur(jnp.asarray(x), sigma, size))
    got = timage.gaussian_blur(torch.from_numpy(x), sigma, size).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("num_classes", [None, 3])
def test_synthetic_sr_items_match_jax(num_classes):
    kw = dict(DATA, num_classes=num_classes)
    got, want = SyntheticRGBDSR(**kw), JSyntheticRGBDSR(**kw)
    assert len(got) == len(want) and got.num_classes == want.num_classes
    assert got.image_size_lr == want.image_size_lr == 16
    assert DATASETS["SyntheticRGBDSR"] is SyntheticRGBDSR
    for name in ("ImageNetSR", "SingleCategorySR"):  # file-backed (tests/test_torch_data_files.py)
        assert issubclass(DATASETS[name], SRDataset)
    for i in (0, 5):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b) and a["y"].shape == (16, 16, 4)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


def test_sr_unet_converted_from_flax_matches_jax():
    """An SR-shaped flax tree through ``flax_to_state_dict``: the port's
    forward equals the JAX one, with classes and the null class."""
    port, jm, params = sr_pair(seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 32, 32, 8)).astype(np.float32)
    t, c = np.array([99, 40, 0]), np.array([2, -1, 0])
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(c, jnp.int32)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c)).numpy()
    assert rel(got, want) < 1e-5


def test_sr_training_loss_and_grads_match_jax():
    """``SuperResCFG.training_loss``: the timesteps, noise and label drops
    (``p_uncond`` 0.5) replayed; the loss and every gradient."""
    port, jm, params = sr_pair(SMALL, seed=3)
    port.train()
    fw_t = torch_framework("SuperResCFG", port, FW)
    fw_j = jax_framework("SuperResCFG", jm, FW)
    batch = _sr_batch(4)
    key = jax.random.PRNGKey(5)
    (want, _), gj = jax.jit(jax.value_and_grad(fw_j.training_loss, has_aux=True))(
        params, key, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["classes"] = tb["classes"].long()
    loss, metrics = fw_t.training_loss(JaxReplayNoise(key), tb)
    loss.backward()
    assert abs(float(metrics["loss"]) - float(want)) <= 1e-5 * float(want)
    gt = _to_flax({k: p.grad for k, p in port.named_parameters()}, SMALL)
    gj = _flat(gj)
    assert gt.keys() == gj.keys()
    for k in gj:
        r = np.linalg.norm(gt[k] - gj[k]) / max(np.linalg.norm(gj[k]), 1e-12)
        assert r < 1e-4, (k, r)


def test_sr_guided_ddim_matches_jax():
    """Guided DDIM on ``SuperResCFG`` (CFG over one batched forward of the
    class and the null class; one label already null), eta > 0 so the step
    noise matters."""
    port, jm, params = sr_pair(SMALL, seed=4)
    tfw = torch_framework("SuperResCFG", port, FW)
    jfw = jax_framework("SuperResCFG", jm, FW)
    y = np.random.default_rng(6).uniform(-1, 1, (2, 16, 16, 4)).astype(np.float32)
    classes = np.array([1, -1])
    key = jax.random.PRNGKey(8)
    want = jsamp.ddim_sample(jfw, params, key, num=2, image_size=32,
                             cond={"y": jnp.asarray(y), "classes": jnp.asarray(classes, jnp.int32)},
                             guidance=2.0, steps=5, eta=0.5)["samples"]
    got = tsamp.ddim_sample(tfw, JaxReplayNoise(key), num=2, image_size=32,
                            cond={"y": torch.from_numpy(y), "classes": torch.from_numpy(classes)},
                            guidance=2.0, steps=5, eta=0.5)["samples"]
    assert np.isfinite(np.asarray(want)).all()
    assert rel(got, want) < 1e-4


def _save_small(tmp_path, in_channels, seed=7):
    """A port checkpoint of the SR widths with ``in_channels`` inputs."""
    model = adm.randomize_parameters(
        adm.build_adm_unet(dict(SR, in_channels=in_channels), dtype=torch.float32), seed)
    path = str(tmp_path / f"model_{in_channels}.pt")
    ckpt_io.save(path, model.state_dict())
    return path, model.state_dict()


@pytest.mark.parametrize("target", [8, 9])
def test_finetune_load_matches_jax(tmp_path, target):
    """A 4-input checkpoint padded to ``target`` inputs: the port's
    ``finetune_load`` equals the JAX one of the same file (carried back by
    ``flax_to_state_dict``); the added input channels are zero."""
    path, src = _save_small(tmp_path, 4)
    cfg = dict(SR, in_channels=target)
    model = adm.build_adm_unet(cfg, dtype=torch.float32)
    got = ckpt_io.finetune_load(path, model.state_dict())
    template = jax.device_get(random_flax(cfg, 0))
    want = flax_to_state_dict(jckpt.finetune_load(path, template, cfg), **cfg)
    assert sorted(got) == sorted(want) == sorted(model.state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    w = got[ckpt_io.IN_CONV]
    assert w.shape[1] == target and torch.equal(w[:, :4], src[ckpt_io.IN_CONV])
    assert not w[:, 4:].any()


def test_finetune_load_takes_a_reference_checkpoint_and_rejects_mismatches(tmp_path):
    """A reference state dict carries ``freqs`` buffers, which are dropped;
    wider inputs than the model's, another width and missing names raise."""
    path, src = _save_small(tmp_path, 8)
    ref = dict(src, **{"time_embed.0.freqs": torch.zeros(8)})
    ckpt_io.save(str(tmp_path / "ref.pt"), ref)
    model = adm.build_adm_unet(SR, dtype=torch.float32)
    got = ckpt_io.finetune_load(str(tmp_path / "ref.pt"), model.state_dict())
    assert all(torch.equal(got[k], src[k]) for k in src) and len(got) == len(src)
    with pytest.raises(ValueError, match="more than 4"):
        ckpt_io.finetune_load(path, adm.build_adm_unet(dict(SR, in_channels=4)).state_dict())
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt_io.finetune_load(path, adm.build_adm_unet(dict(SR, model_channels=32)).state_dict())
    ckpt_io.save(str(tmp_path / "cut.pt"), {k: v for k, v in src.items() if "label_emb" not in k})
    with pytest.raises(ValueError, match="missing"):
        ckpt_io.finetune_load(str(tmp_path / "cut.pt"), model.state_dict())


def _sr_trainer(tmp, cfg=SR, fw_args=FW, **kwargs):
    model = adm.build_adm_unet(cfg, dtype=torch.float32)
    fw = torch_framework("SuperResCFG", model, fw_args)
    args = dict(max_steps=1, batch_size=8, batch_split=2, ema_rate=[0.9], i_log=1,
                i_sample=10 ** 9, i_save=10 ** 9, sample_at_init=False, device="cpu")
    args.update(kwargs)
    return SuperResTrainer(fw, SyntheticRGBDSR(**DATA), str(tmp), **args)


def test_sr_trainer_step_with_ema_matches_jax(tmp_path):
    """One ``SuperResTrainer`` step of 8 with ``batch_split`` 2 (replayed keys,
    the same weights and batch) against the JAX trainer's: AdamW with
    optax's defaults, then the EMA."""
    tr = _sr_trainer(tmp_path / "port", SMALL)
    assert TRAINERS["SuperResTrainer"] is SuperResTrainer
    params = random_flax(SMALL, 9)
    tr.model.load_state_dict(flax_to_state_dict(jax.device_get(params), **SMALL))
    for ema in tr.ema_params:
        for k, v in ema.items():
            v.copy_(tr.params[k].detach())
    jtr = JSuperResTrainer(
        jax_framework("SuperResCFG", jax_build(SMALL), FW), JSyntheticRGBDSR(**DATA),
        str(tmp_path / "jax"), max_steps=1, batch_size=8, batch_split=2, ema_rate=[0.9],
        i_log=1, i_sample=10 ** 9, i_save=10 ** 9, sample_at_init=False)
    start = _flat(params)
    jtr.params = jax.device_put(params, jtr.param_sharding)
    jtr.opt_state = jax.device_put(jtr.tx.init(params), jtr._opt_sharding)
    batch = _sr_batch(8)
    key = jax.random.PRNGKey(11)
    new, _, (ema,), metrics = jtr._step_fn(jtr.params, jtr.opt_state,
                                           [jax.tree.map(jnp.array, params)], key,
                                           jtr._global_batch(batch))
    got_metrics = tr._train_step(tr._device_batch(batch), JaxReplayNoise(key))
    assert abs(float(got_metrics["loss"]) - float(metrics["loss"])) <= 1e-5 * float(metrics["loss"])
    got, want = _to_flax(tr.model.state_dict(), SMALL), _flat(new)
    got_ema = _to_flax(tr.ema_params[0], SMALL)
    close = total = 0
    for k in want:
        np.testing.assert_allclose(got_ema[k], 0.9 * start[k] + 0.1 * got[k], atol=1e-8,
                                   rtol=2.4e-7)
        step_t, step_j = got[k] - start[k], want[k] - start[k]
        np.testing.assert_allclose(step_t, step_j, atol=2e-4 + 1e-6, rtol=0, err_msg=k)
        sure = ((np.abs(step_j) > 0.999e-4) & (np.abs(step_t) > 0.999e-4)
                & (np.sign(step_t) == np.sign(step_j)))
        np.testing.assert_allclose(got[k][sure], want[k][sure], atol=1e-6, rtol=0, err_msg=k)
        close += (np.abs(got[k] - want[k]) <= 1e-6).sum()
        total += sure.size
    assert close >= 0.999 * total, close / total


def test_sr_trainer_finetunes_and_writes_sample_grids(tmp_path):
    """``SuperResTrainer(finetune_ckpt=...)`` starts from a 4-input
    checkpoint padded to 8 (the EMA too), trains a step, and its ``sample``
    writes the JAX trainer's six grids."""
    path, src = _save_small(tmp_path, 4)
    tr = _sr_trainer(tmp_path / "run", fw_args=dict(FW, timesteps=25), finetune_ckpt=path)
    w = tr.model.state_dict()[ckpt_io.IN_CONV]
    assert torch.equal(w[:, :4], src[ckpt_io.IN_CONV]) and not w[:, 4:].any()
    assert all(torch.equal(tr.ema_params[0][k], p) for k, p in tr.params.items())
    tr.run()
    assert tr.step == 1
    tr.sample(num_samples=4)
    names = sorted(os.listdir(tmp_path / "run" / "samples"))
    assert names == sorted(f"{n}_step0000001.png" for n in
                           ("rgb_gt", "rgb_cond", "rgb", "depth_gt", "depth_cond", "depth"))


def test_inpaint_trainer_finetunes_from_a_checkpoint(tmp_path):
    """``InpaintTrainer(finetune_ckpt=...)`` loads a 4-input unconditional
    checkpoint into its 10-input model, as the JAX ``finetune_load`` pads
    it."""
    from ivid_tpu_torch.data import SyntheticRGBDWarp

    path, _ = _save_small(tmp_path, 4)
    cfg = dict(SR, in_channels=10)
    fw = torch_framework("InpaintCFG", adm.build_adm_unet(cfg, dtype=torch.float32),
                         {"timesteps": 100, "beta_schedule": "linear", "p_uncond": 0.1})
    data = SyntheticRGBDWarp(**{k: v for k, v in DATA.items() if k != "image_size_lr"})
    tr = InpaintTrainer(fw, data, str(tmp_path / "inpaint"), max_steps=1, batch_size=2,
                        sample_at_init=False, device="cpu", finetune_ckpt=path)
    want = flax_to_state_dict(jckpt.finetune_load(path, jax.device_get(random_flax(cfg, 0)), cfg),
                              **cfg)
    got = tr.model.state_dict()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def _write_config(tmp_path):
    import json

    cfg = {"backbone": {"name": "AdmUnet2d", "args": SMALL},
           "framework": {"name": "SuperResCFG", "args": FW}}
    (tmp_path / "sr.json").write_text(json.dumps(cfg))
    return str(tmp_path / "sr.json")


def _write_scenes(tmp_path):
    """Two 2-view 16² scenes saved by the JAX ``save_scene``: one named with
    a seed (class 4 % 3 = 1, so CFG runs) and one without (no CFG)."""
    rng = np.random.default_rng(0)
    (tmp_path / "scenes").mkdir()
    for name, mv in (("plain", jcam.look_at(jnp.array([0.3, 0.0, 1.0]), jnp.zeros(3),
                                             jnp.array([0.0, 1.0, 0.0]))),
                     ("scene_seed00004", jnp.eye(4))):
        meshes, colors = [], []
        for _ in range(2):
            rgbd = rng.uniform(0.2, 0.8, size=(16, 16, 4)).astype(np.float32)
            meshes.append(jgeom.depth_to_mesh(
                jgeom.linearize_depth(jnp.asarray(rgbd[..., 3:]), 0.6, 5.0), padding="frustum",
                fov=45.0, modelview=mv, atol=0.03, rtol=0.03, erode_rgb=3, cal_normal=True))
            colors.append(rgbd[..., :3])
        jax_save_scene(str(tmp_path / "scenes" / f"{name}.npz"), meshes, colors)


def test_sr_cli_matches_jax_sr_batch(tmp_path):
    """``python -m ivid_tpu_torch.sr`` with ``--ckpt_sr random`` on two saved
    scenes, in chunks of one view, against the root ``sr.py``'s steps on the
    JAX side: its ``load_scene``, its view preparation and its ``sr_batch``
    (guided DDIM, key ``PRNGKey(1000 * si + i)``) with the same weights."""
    _write_scenes(tmp_path)
    result = sr.main(["--config_sr", _write_config(tmp_path), "--ckpt_sr", "random",
                      "--scene_dir", str(tmp_path), "--steps", "3", "--batchsize", "1",
                      "--save_scenes", "--device", "cpu"],
                     noise=lambda seed: JaxReplayNoise(jax.random.PRNGKey(seed)))
    assert result["output_dir"] == str(tmp_path) and result["stage_ms"] == {}

    model = adm.randomize_parameters(adm.build_adm_unet(SMALL), 0)
    params = jax.tree.map(jnp.asarray, torch_state_dict_to_flax(
        {k: v.numpy() for k, v in model.state_dict().items()}, **{k: SMALL[k] for k in ARCH_KEYS}))
    jfw = jax_framework("SuperResCFG", jax_build(SMALL, dtype=jnp.float32), FW)
    names = ["plain", "scene_seed00004"]
    for si, (name, got) in enumerate(zip(names, result["samples"])):
        meshes, colors = jax_load_scene(str(tmp_path / "scenes" / f"{name}.npz"))
        views = np.stack([np.concatenate([c, np.asarray(jgeom.project_depth(
            np.asarray(m.depth), 0.6, 5.0))], -1) for m, c in zip(meshes, colors)])
        want = []
        for i in range(2):
            y = jnp.asarray(views[i:i + 1] * 2 - 1)
            cond = {"y": y}
            if si == 1:
                cond["classes"] = jnp.full((1,), 4 % 3, jnp.int32)
            out = jsamp.ddim_sample(jfw, params, jax.random.PRNGKey(1000 * si + i), num=1,
                                    image_size=32, cond=cond, guidance=3.0 if si else 0.0,
                                    steps=3)["samples"]
            want.append(np.asarray(out) * 0.5 + 0.5)
        want = np.concatenate(want)
        assert got.shape == want.shape == (2, 32, 32, 4)
        assert rel(got, want) < 1e-4, (name, rel(got, want))
        assert (tmp_path / "results_sr" / f"{name}.png").exists()
        sr_meshes, sr_colors = load_scene(str(tmp_path / "scenes_sr" / f"{name}.npz"),
                                          device="cpu")
        assert [c.shape for c in sr_colors] == [(32, 32, 3)] * 2
        for m, v, mesh in zip(sr_meshes, want, meshes):
            lin = np.asarray(jgeom.linearize_depth(jnp.asarray(v[..., 3:]), 0.6, 5.0))
            assert rel(m.depth.numpy(), lin) < 1e-4
            np.testing.assert_allclose(m.modelview.numpy(), np.asarray(mesh.modelview),
                                       atol=1e-6)


def test_sr_cli_needs_the_card_by_default(tmp_path):
    """Without ``--device`` the CLI runs on ``cuda``: with no card it fails
    before it writes anything, and does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _write_scenes(tmp_path)
    with pytest.raises((RuntimeError, AssertionError)):
        sr.main(["--config_sr", _write_config(tmp_path), "--ckpt_sr", "random",
                 "--scene_dir", str(tmp_path)])
    assert not (tmp_path / "results_sr").exists()
