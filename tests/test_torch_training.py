"""The port's training path vs the JAX package (CPU): losses, trainer steps,
checkpoints and the training CLI.

The JAX trainer draws from ``jax.random`` keys; the port routes every draw
through a noise source, and :class:`JaxReplayNoise` (the sampler tests'
source, with ``uniform``/``randint``) replays those keys, so both sides see
the same timesteps, noise and label drops. Weights go from the port to the
JAX tree through the JAX package's own converter.

Tolerances, and why:
- ``training_loss`` value 1e-5 relative and gradients 1e-4 relative L2 per
  tensor: two f32 UNets that agree to ~1e-6 per forward, reduced over the
  batch.
- One AdamW step: AdamW's first update is lr·g/(|g|+eps), a full step of
  lr·sign(g) = 1e-4 unless |g| lies within ~1000 eps of 0, where the two
  frameworks' gradient roundings decide its size and sign. Parameters must
  agree to 1e-6 (1% of a step) wherever both steps are full and agree in
  sign; 99.9% of all elements in f32, and 98% with the bf16 torso (whose
  bf16 gradients differ by their rounding), must agree to 1e-6; every
  element is within one step either way. Both sides keep f32 master
  weights.
- EMA within 2 f32 ulps of ``0.9·start + 0.1·param`` evaluated in numpy
  (one multiply-add of the same f32 values, rounded in another order).
- ``batch_split=2`` vs one batch: gradients of the two halves averaged, the
  same up to f32 summation order (1e-6 relative after an SGD step).
- Kill and resume: the same loss sequence exactly (same arithmetic, same
  draws, same batches).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivid_tpu.data import SyntheticRGBD as JSyntheticRGBD
from ivid_tpu.diffusion import build_framework as jax_framework
from ivid_tpu.models import build_adm_unet as jax_build
from ivid_tpu.models.torch_compat import torch_state_dict_to_flax
from ivid_tpu.training.trainer import BasicTrainer as JBasicTrainer
from ivid_tpu_torch import train
from ivid_tpu_torch.data import SyntheticRGBD
from ivid_tpu_torch.diffusion.frameworks import build_framework as torch_framework
from ivid_tpu_torch.diffusion.noise import TorchNoise
from ivid_tpu_torch.models import adm
from ivid_tpu_torch.training import checkpoint as ckpt_io
from ivid_tpu_torch.training.trainer import BasicTrainer, StepRecord

from test_torch_diffusion import JaxReplayNoise

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE = dict(
    image_size=16, in_channels=4, out_channels=4, model_channels=16,
    num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[8],
    num_groups=8, num_heads=None, num_head_channels=16, num_classes=3,
    has_null_class=True, dropout=0.0, use_fp16=False,
)
ARCH_KEYS = ["image_size", "model_channels", "num_res_blocks", "channel_mult",
             "attention_resolutions", "num_classes"]
FW = {"timesteps": 100, "beta_schedule": "linear", "p_uncond": 0.5}
DATA = dict(image_size=16, length=32, num_classes=3, normalize=True, normalize_depth=True,
            prepocess_depth="z_buffer")


def _flax(model, cfg):
    sd = {k: v.detach().float().numpy().copy() for k, v in model.state_dict().items()}
    return jax.tree.map(jnp.asarray, torch_state_dict_to_flax(sd, **{k: cfg[k] for k in ARCH_KEYS}))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_trainer(tmp, cfg=BACKBONE, seed=0, **kwargs):
    model = adm.randomize_parameters(adm.build_adm_unet(cfg), seed)
    fw = torch_framework("ClassifierFreeGuidance", model, FW)
    args = dict(max_steps=4, batch_size=8, i_log=2, i_sample=10 ** 9, i_save=10 ** 9,
                sample_at_init=False, device="cpu")
    args.update(kwargs)
    return BasicTrainer(fw, SyntheticRGBD(**DATA), str(tmp), **args)


def _batch(n=8):
    ds = SyntheticRGBD(**DATA)
    items = [ds[i] for i in range(n)]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def test_training_loss_value_and_grads_match_jax():
    port = adm.randomize_parameters(adm.build_adm_unet(BACKBONE), 3)
    fw_t = torch_framework("ClassifierFreeGuidance", port, FW)
    fw_j = jax_framework("ClassifierFreeGuidance", jax_build(BACKBONE, dtype=jnp.float32), FW)
    params = _flax(port, BACKBONE)
    batch = _batch(4)
    key = jax.random.PRNGKey(5)
    (want, _), gj = jax.jit(jax.value_and_grad(fw_j.training_loss, has_aux=True))(
        params, key, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = fw_t.training_loss(JaxReplayNoise(key), {
        "x_0": torch.from_numpy(batch["x_0"]), "classes": torch.from_numpy(batch["classes"]).long()})
    loss.backward()
    assert abs(float(metrics["loss"]) - float(want)) <= 1e-5 * float(want)
    assert float(metrics["mse"]) == float(metrics["loss"])
    gt = _flax_grads(port, BACKBONE)
    gj = _flat(gj)
    assert gt.keys() == gj.keys()
    for k in gj:
        rel = np.linalg.norm(gt[k] - gj[k]) / max(np.linalg.norm(gj[k]), 1e-12)
        assert rel < 1e-4, (k, rel)


def _flax_grads(model, cfg):
    sd = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return _flat(jax.tree.map(jnp.asarray, torch_state_dict_to_flax(
        sd, **{k: cfg[k] for k in ARCH_KEYS})))


def test_inpaint_loss_with_image_dropout_matches_jax():
    """InpaintCFG's ``p_uncond_img`` branch: 9-channel packings (no
    ``mask_rgb``), the per-sample choice between the condition and the
    fully unconditioned packing, all draws replayed."""
    cfg = dict(BACKBONE, in_channels=9, num_classes=None, has_null_class=False)
    fa = {"timesteps": 100, "beta_schedule": "linear", "p_uncond": 0.1, "p_uncond_img": 0.5}
    port = adm.randomize_parameters(adm.build_adm_unet(cfg), 4)
    fw_t = torch_framework("InpaintCFG", port, fa)
    fw_j = jax_framework("InpaintCFG", jax_build(cfg, dtype=jnp.float32), fa)
    params = _flax(port, cfg)
    rng = np.random.default_rng(2)
    batch = {"x_0": rng.uniform(-1, 1, (4, 16, 16, 4)).astype(np.float32),
             "y": rng.uniform(-1, 1, (4, 16, 16, 4)).astype(np.float32),
             "mask": (rng.uniform(size=(4, 16, 16, 1)) > 0.5).astype(np.float32)}
    key = jax.random.PRNGKey(1)
    drop = np.asarray(jax.random.uniform(jax.random.split(key, 6)[4], (4, 1, 1, 1))) < 0.5
    assert 0 < drop.sum() < 4  # both branches are taken
    (want, _), gj = jax.jit(jax.value_and_grad(fw_j.training_loss, has_aux=True))(
        params, key, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = fw_t.training_loss(JaxReplayNoise(key),
                                       {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(float(metrics["loss"]) - float(want)) <= 1e-5 * float(want)
    gt = _flax_grads(port, cfg)
    gj = _flat(gj)
    for k in gj:
        rel = np.linalg.norm(gt[k] - gj[k]) / max(np.linalg.norm(gj[k]), 1e-12)
        assert rel < 1e-4, (k, rel)


@pytest.mark.parametrize("use_fp16", [False, True], ids=["f32", "bf16-torso"])
def test_trainer_step_with_ema_matches_jax(tmp_path, use_fp16):
    """One train step (replayed keys, same weights and batch) against the JAX
    ``BasicTrainer._train_step``: AdamW with optax's defaults, then the EMA.
    With the bf16 torso both keep f32 master weights (before the port kept
    bf16 weights, which lost the ~1e-4 update below bf16's resolution)."""
    cfg = dict(BACKBONE, use_fp16=use_fp16)
    tr = _port_trainer(tmp_path / "port", cfg, seed=6, ema_rate=[0.9])
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    jtr = JBasicTrainer(
        jax_framework("ClassifierFreeGuidance", jax_build(cfg), FW),
        JSyntheticRGBD(**DATA), str(tmp_path / "jax"), max_steps=4, batch_size=8,
        ema_rate=[0.9], i_log=2, i_sample=10 ** 9, i_save=10 ** 9, sample_at_init=False,
    )
    p0 = _flax(tr.model, cfg)
    start = _flat(p0)  # the step donates its inputs
    jtr.params = jax.device_put(p0, jtr.param_sharding)
    jtr.opt_state = jax.device_put(jtr.tx.init(p0), jtr._opt_sharding)
    ema0 = jax.tree.map(jnp.array, p0)
    batch = _batch()
    key = jax.random.PRNGKey(9)
    params, _, (ema,), metrics = jtr._step_fn(
        jtr.params, jtr.opt_state, [ema0], key, jtr._global_batch(batch))

    got_metrics = tr._train_step(tr._device_batch(batch), JaxReplayNoise(key))
    assert abs(float(got_metrics["loss"]) - float(metrics["loss"])) <= (
        1e-5 if not use_fp16 else 2e-2) * float(metrics["loss"])
    got = _flat(_flax(tr.model, cfg))
    want = _flat(params)
    got_ema = _flat(jax.tree.map(jnp.asarray, torch_state_dict_to_flax(
        {k: v.numpy() for k, v in tr.ema_params[0].items()}, **{k: cfg[k] for k in ARCH_KEYS})))
    # AdamW's first step is lr·g/(|g|+eps): a full step of lr = 1e-4 unless
    # |g| is within ~1000 eps of 0, where the two frameworks' roundings decide.
    close = total = 0
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_allclose(got_ema[k], 0.9 * start[k] + 0.1 * got[k], atol=1e-8,
                                   rtol=2.4e-7)
        step_t, step_j = got[k] - start[k], want[k] - start[k]
        np.testing.assert_allclose(step_t, step_j, atol=2e-4 + 1e-6, rtol=0, err_msg=k)
        sure = ((np.abs(step_j) > 0.999e-4) & (np.abs(step_t) > 0.999e-4)
                & (np.sign(step_t) == np.sign(step_j)))
        np.testing.assert_allclose(got[k][sure], want[k][sure], atol=1e-6, rtol=0, err_msg=k)
        close += (np.abs(got[k] - want[k]) <= 1e-6).sum()
        total += sure.size
    assert close >= (0.98 if use_fp16 else 0.999) * total, close / total


def test_batch_split_equals_one_batch(tmp_path):
    """A deterministic loss and SGD: with ``batch_split=2`` the averaged
    microbatch gradients give the same parameters as the whole batch."""
    trainers = [_port_trainer(tmp_path / str(n), seed=7, batch_split=n) for n in (1, 2)]
    for tr in trainers:
        model = tr.model

        def det_loss(rng, batch, model=model):
            del rng
            x = batch["x_0"]
            out = model(x, torch.full((x.shape[0],), 5), batch["classes"])
            loss = torch.mean((out - x) ** 2)
            return loss, {"loss": loss.detach()}

        tr.framework.training_loss = det_loss
        tr.optimizer = torch.optim.SGD(tr.model.parameters(), lr=0.05)
    batch = _batch()
    for tr in trainers:
        tr._train_step(tr._device_batch(batch), TorchNoise.seeded(0))
    a, b = (dict(tr.model.named_parameters()) for tr in trainers)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-7, msg=k)


def test_kill_and_resume_reproduces_the_loss_sequence(tmp_path):
    full = _port_trainer(tmp_path / "full", seed=2, i_save=2)
    full.record = StepRecord()
    full.run()
    first = _port_trainer(tmp_path / "cut", seed=2, i_save=2, max_steps=2)
    first.record = StepRecord()
    first.run()
    assert ckpt_io.find_latest_step(str(tmp_path / "cut")) == 2
    resumed = _port_trainer(tmp_path / "cut", seed=11, i_save=2)
    resumed.load(str(tmp_path / "cut"), 2)
    assert resumed.step == 2
    resumed.record = StepRecord()
    resumed.run()
    seq = [float(x) for x in first.record.losses + resumed.record.losses]
    assert seq == [float(x) for x in full.record.losses]
    for (k, a), b in zip(full.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), k


def test_train_cli_two_steps_on_cpu(tmp_path):
    """``python -m ivid_tpu_torch.train`` on the synthetic test config (the
    initial sample grid switched off in a copy, to keep the test short), then
    a resume from its last checkpoint."""
    with open(os.path.join(REPO, "configs", "rgbd_synthetic_adm_32_test.json")) as f:
        cfg = json.load(f)
    cfg["trainer"]["args"].update(sample_at_init=False, i_save=2, i_log=2)
    path = tmp_path / "rgbd_synthetic_adm_32_test.json"
    path.write_text(json.dumps(cfg))
    argv = ["--config", str(path), "--output_dir", str(tmp_path / "out"), "--max_steps", "2",
            "--device", "cpu"]
    rec = StepRecord()
    tr = train.main(argv, record=rec)
    run_dir = tmp_path / "out" / "rgbd_synthetic_adm_32_test"
    assert tr.step == 2 and len(rec.losses) == 2 and rec.events == []
    assert all(np.isfinite(float(x)) for x in rec.losses)
    assert sorted(os.listdir(run_dir / "ckpts")) == [
        "ema_0.9999_step0000002.pt", "misc_step0000002.pt", "model_step0000002.pt"]
    assert (run_dir / "config.json").exists() and (run_dir / "command.txt").exists()
    assert "2: " in (run_dir / "log.txt").read_text()
    again_rec = StepRecord()
    again = train.main(argv + ["--ckpt", "latest"], record=again_rec)
    assert again.step == 2 and again_rec.losses == []
    for (k, a), b in zip(tr.model.state_dict().items(), again.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_inpaint_trainer_steps_and_writes_sample_grids(tmp_path):
    """An InpaintTrainer step synthesizes the warp conditioning and trains
    the 10-channel model; its ``sample`` writes the JAX package's grids, as
    does BasicTrainer's (CFG over classes)."""
    from ivid_tpu_torch.data import SyntheticRGBDWarp
    from ivid_tpu_torch.training.trainer import InpaintTrainer

    cfg = dict(BACKBONE, in_channels=10, num_classes=None, has_null_class=False)
    fw = torch_framework("InpaintCFG", adm.randomize_parameters(adm.build_adm_unet(cfg), 1),
                         {"timesteps": 100, "beta_schedule": "linear", "p_uncond": 0.1})
    data = SyntheticRGBDWarp(**dict(DATA, num_classes=None),
                             augments=["prewarp_noise", "blur", "erode_rgb"])
    tr = InpaintTrainer(fw, data, str(tmp_path / "inpaint"), max_steps=1, batch_size=2,
                        i_log=1, i_sample=10 ** 9, i_save=10 ** 9, sample_at_init=False,
                        device="cpu")
    batch = tr.synthesize_cond(tr._device_batch(_batch(2)), TorchNoise.seeded(3))
    assert batch["y"].shape == (2, 16, 16, 4) and batch["mask_rgb"].shape == (2, 16, 16, 1)
    assert batch["pose"].shape == (2, 2) and 0 < float(batch["mask"].mean()) < 1
    tr.record = StepRecord()
    tr.run()
    assert tr.step == 1 and np.isfinite(float(tr.record.losses[0]))
    tr.sample(num_samples=4, batch_size=4)
    names = sorted(os.listdir(tmp_path / "inpaint" / "samples"))
    assert names == sorted(f"{k}_step0000001.png" for k in (
        "mask", "rgb_gt", "rgb_cond", "rgb", "depth_gt", "depth_cond", "depth", "mask_rgb"))
    basic = _port_trainer(tmp_path / "basic", seed=1)
    basic.framework = torch_framework("ClassifierFreeGuidance", basic.model,
                                      dict(FW, timesteps=40))
    basic.sample(suffix="init", num_samples=4, batch_size=2)
    assert sorted(os.listdir(tmp_path / "basic" / "samples")) == ["depth_init.png", "rgb_init.png"]
