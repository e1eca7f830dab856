"""The flagship 1000-class uncond model (``configs/rgbd_imagenet_adm_128_large_cfg.json``,
``sample.py``'s default) cut to CPU size, port against the JAX package.

The cut keeps what the flagship forces on the port: 1000 classes with the
null class, classifier-free guidance, f32 (``use_fp16: false``), 64-wide
heads, and an attention site at T >= 512 (32², which takes the packed
attention's path: its kernel K1 f32 on the card, its plain version here).
Widths and depth are cut (32², 64 channels, one res block, two levels).
Tolerances: 1e-4 relative L2, as the other chain and training tests (two f32
UNets that agree to ~1e-6 per call).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ivid_tpu.diffusion import build_framework as jax_framework
from ivid_tpu.diffusion import samplers as jsamp
from ivid_tpu.models import build_adm_unet as jax_build
from ivid_tpu_torch.config import Config
from ivid_tpu_torch.diffusion import samplers as tsamp
from ivid_tpu_torch.diffusion.frameworks import build_framework as torch_framework
from ivid_tpu_torch.diffusion.noise import TorchNoise
from ivid_tpu_torch.models import adm
from ivid_tpu_torch.ops import attention as tattn

from test_torch_diffusion import JaxReplayNoise, model_pair, rel
from test_torch_training import REPO, _flat, _flax, _flax_grads

torch.set_num_threads(2)

FLAGSHIP = "rgbd_imagenet_adm_128_large_cfg.json"
REL = 1e-4


def _cut():
    """The flagship config at CPU size, and its framework arguments."""
    cfg = Config.load(f"{REPO}/configs/{FLAGSHIP}")
    args = dict(cfg.backbone["args"], image_size=32, model_channels=64, num_res_blocks=1,
                channel_mult=[1, 2], attention_resolutions=[32, 16])
    assert cfg.framework["name"] == "ClassifierFreeGuidance"
    assert args["num_classes"] == 1000 and args["has_null_class"] and not args["use_fp16"]
    assert args["num_head_channels"] == tattn.HEAD_DIM
    return args, dict(cfg.framework["args"])


def _count_packed(monkeypatch):
    """Token counts of the calls that reach the packed attention's wrapper."""
    calls = []
    real = tattn.packed_attention
    monkeypatch.setattr(tattn, "packed_attention",
                        lambda *a: calls.append(a[0].shape[1]) or real(*a))
    return calls


def test_flagship_cfg_ddim_matches_jax(monkeypatch):
    """Strided CFG DDIM at the CLI's guidance 3 over classes at both ends of
    the 1000, from the same x_T."""
    args, fa = _cut()
    port, jm, params = model_pair(args, seed=0)
    tfw = torch_framework("ClassifierFreeGuidance", port, fa)
    jfw = jax_framework("ClassifierFreeGuidance", jm, fa)
    noise = np.random.default_rng(1).standard_normal((2, 32, 32, 4)).astype(np.float32)
    classes = np.array([7, 999])
    calls = _count_packed(monkeypatch)
    got = tsamp.ddim_sample(tfw, TorchNoise.seeded(0), noise=torch.from_numpy(noise),
                            cond={"classes": torch.from_numpy(classes)}, guidance=3.0,
                            steps=3)["samples"]
    want = jsamp.ddim_sample(jfw, params, jax.random.PRNGKey(0), noise=jnp.asarray(noise),
                             cond={"classes": jnp.asarray(classes, jnp.int32)},
                             guidance=3.0, steps=3)["samples"]
    assert rel(got, want) < REL
    # 3 steps, each one fused forward of the cond and null batch through the
    # three T >= 512 sites of the 32² level (one down, two up).
    assert calls == [1024] * 3 * 3


def test_flagship_training_loss_and_grads_match_jax(monkeypatch):
    """The BasicTrainer's loss on the flagship (CFG label drop over 1000
    classes, replayed draws) and every parameter's gradient."""
    args, fa = _cut()
    port = adm.randomize_parameters(adm.build_adm_unet(args), 3)
    fw_t = torch_framework("ClassifierFreeGuidance", port, fa)
    fw_j = jax_framework("ClassifierFreeGuidance", jax_build(args, dtype=jnp.float32), fa)
    params = _flax(port, args)
    rng = np.random.default_rng(4)
    batch = {"x_0": rng.uniform(-1, 1, (2, 32, 32, 4)).astype(np.float32),
             "classes": np.array([0, 999], np.int32)}
    key = jax.random.PRNGKey(5)
    (want, _), gj = jax.jit(jax.value_and_grad(fw_j.training_loss, has_aux=True))(
        params, key, {k: jnp.asarray(v) for k, v in batch.items()})
    calls = _count_packed(monkeypatch)
    loss, metrics = fw_t.training_loss(JaxReplayNoise(key), {
        "x_0": torch.from_numpy(batch["x_0"]), "classes": torch.from_numpy(batch["classes"]).long()})
    loss.backward()
    assert calls == [1024] * 3
    assert abs(float(metrics["loss"]) - float(want)) <= 1e-5 * float(want)
    gt, gj = _flax_grads(port, args), _flat(gj)
    assert gt.keys() == gj.keys()
    for k in gj:
        r = np.linalg.norm(gt[k] - gj[k]) / max(np.linalg.norm(gj[k]), 1e-12)
        assert r < REL, (k, r)
