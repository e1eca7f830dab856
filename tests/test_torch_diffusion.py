"""Port schedules, frameworks and samplers vs the JAX package (f32, CPU).

The JAX chains draw their noise from ``jax.random`` keys, which a
``torch.Generator`` cannot reproduce. The port routes every draw through a
noise source whose ``split``/``fold_in`` follow the JAX derivation, so
:class:`JaxReplayNoise` below (a test-local source that replays the JAX keys)
makes the port's stochastic chains equal to the JAX ones, not just alike.

Tolerances: schedule tables exactly (both are float64 numpy cast to f32);
``apply_pred_x0_edits`` 1e-6; chains 1e-4 relative L2 (two f32 UNets that
agree to ~1e-6 per call, over 10-100 steps of a random-weight model whose
samples grow to O(100)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivid_tpu.diffusion import build_framework as jax_framework
from ivid_tpu.diffusion import samplers as jsamp
from ivid_tpu.diffusion import schedules as jsched
from ivid_tpu.models import build_adm_unet as jax_build
from ivid_tpu.models.torch_compat import torch_state_dict_to_flax
from ivid_tpu_torch.diffusion import samplers as tsamp
from ivid_tpu_torch.diffusion import schedules as tsched
from ivid_tpu_torch.diffusion.frameworks import build_framework as torch_framework
from ivid_tpu_torch.diffusion.noise import TorchNoise
from ivid_tpu_torch.models import adm

torch.set_num_threads(2)

CHAIN_REL = 1e-4
BACKBONE = dict(
    image_size=16, in_channels=4, out_channels=4, model_channels=16,
    num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[8],
    num_groups=8, num_heads=None, num_head_channels=16, num_classes=3,
    has_null_class=True, dropout=0.0, use_fp16=False,
)
ARCH_KEYS = ["image_size", "model_channels", "num_res_blocks", "channel_mult",
             "attention_resolutions", "num_classes"]


class JaxReplayNoise:
    """Noise source replaying ``jax.random``: split/fold_in and the
    normal/uniform/randint draws on a key."""

    def __init__(self, key):
        self.key = key

    def split(self, num=2):
        return tuple(JaxReplayNoise(k) for k in jax.random.split(self.key, num))

    def fold_in(self, i):
        return JaxReplayNoise(jax.random.fold_in(self.key, i))

    def normal(self, shape):
        return torch.from_numpy(np.array(jax.random.normal(self.key, tuple(shape))))

    def uniform(self, shape):
        return torch.from_numpy(np.array(jax.random.uniform(self.key, tuple(shape))))

    def randint(self, shape, low, high):
        return torch.from_numpy(np.array(jax.random.randint(self.key, tuple(shape), low, high))).long()


def model_pair(cfg, seed, out_scale=1.0):
    """(port model, flax module, flax params) with the same random weights;
    ``out_scale`` scales the output convolution."""
    port = adm.build_adm_unet(cfg, dtype=torch.float32)
    adm.randomize_parameters(port, seed)
    with torch.no_grad():
        port.out[2].weight.mul_(out_scale)
        port.out[2].bias.mul_(out_scale)
    port.eval()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params = torch_state_dict_to_flax(sd, **{k: cfg[k] for k in ARCH_KEYS})
    return port, jax_build(cfg, dtype=jnp.float32), jax.tree.map(jnp.asarray, params)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name,T", [("linear", 1000), ("cosine", 1000), ("linear", 100)])
def test_schedule_tables_match(name, T):
    j = jsched.Schedule.create(name, T)
    t = tsched.Schedule.create(name, T)
    for field in j.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(t, field).numpy(), np.asarray(getattr(j, field)),
                                      err_msg=field)


def test_apply_pred_x0_edits_matches():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    m = lambda: (rng.uniform(size=(2, 8, 8, 1)) > 0.5).astype(np.float32)
    x, rgb, depth, convex = f(2, 8, 8, 4), f(2, 8, 8, 3), f(2, 8, 8, 1), f(2, 8, 8, 1)
    m_rgb, m_d = m(), m()
    nz = np.array([1.0, 0.0], np.float32).reshape(2, 1, 1, 1)
    je = jsamp.PredX0Edits((0.1, jnp.asarray(rgb), jnp.asarray(m_rgb)),
                           (0.2, jnp.asarray(depth), jnp.asarray(m_d)),
                           (0.5, jnp.asarray(convex)))
    te = tsamp.PredX0Edits((0.1, torch.from_numpy(rgb), torch.from_numpy(m_rgb)),
                           (0.2, torch.from_numpy(depth), torch.from_numpy(m_d)),
                           (0.5, torch.from_numpy(convex)))
    want = np.asarray(jsamp.apply_pred_x0_edits(jnp.asarray(x), je, jnp.asarray(nz)))
    got = tsamp.apply_pred_x0_edits(torch.from_numpy(x), te, torch.from_numpy(nz)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_ddim_cfg_matched_noise_is_deterministic_and_matches():
    """Strided CFG DDIM with eta=0 and a given x_T draws no noise that matters:
    the fused CFG forward (cond + null batch) matches step for step."""
    port, jm, params = model_pair(BACKBONE, seed=0)
    fa = {"timesteps": 100, "beta_schedule": "linear", "p_uncond": 0.1}
    tfw = torch_framework("ClassifierFreeGuidance", port, fa)
    jfw = jax_framework("ClassifierFreeGuidance", jm, fa)
    noise = np.random.default_rng(1).standard_normal((2, 16, 16, 4)).astype(np.float32)
    classes = np.array([0, 2])
    got = tsamp.ddim_sample(tfw, TorchNoise.seeded(0), noise=torch.from_numpy(noise),
                            cond={"classes": torch.from_numpy(classes)}, guidance=1.5,
                            steps=10)["samples"]
    want = jsamp.ddim_sample(jfw, params, jax.random.PRNGKey(0), noise=jnp.asarray(noise),
                             cond={"classes": jnp.asarray(classes, jnp.int32)},
                             guidance=1.5, steps=10)["samples"]
    assert rel(got, want) < CHAIN_REL


def test_ddpm_matches_with_replayed_noise():
    port, jm, params = model_pair(dict(BACKBONE, num_classes=None, has_null_class=False), 1)
    fa = {"timesteps": 100, "beta_schedule": "linear"}
    tfw = torch_framework("GaussianDiffusion", port, fa)
    jfw = jax_framework("GaussianDiffusion", jm, fa)
    key = jax.random.PRNGKey(7)
    got = tsamp.ddpm_sample(tfw, JaxReplayNoise(key), num=2, image_size=16)["samples"]
    want = jsamp.ddpm_sample(jfw, params, key, num=2, image_size=16)["samples"]
    assert np.isfinite(np.asarray(want)).all()
    assert rel(got, want) < CHAIN_REL


def test_inpaint_cfg_guided_ddim_matches_with_replayed_noise():
    """InpaintCFG packing (fresh noise in unseen regions at every call, drawn
    from the replayed keys), CFG over classes, eta > 0 and the x0 edits."""
    cfg = dict(BACKBONE, in_channels=10)
    port, jm, params = model_pair(cfg, seed=2)
    fa = {"timesteps": 100, "beta_schedule": "linear", "p_uncond": 0.1, "p_uncond_img": 0}
    tfw = torch_framework("InpaintCFG", port, fa)
    jfw = jax_framework("InpaintCFG", jm, fa)
    rng = np.random.default_rng(3)
    y = rng.uniform(-1, 1, (2, 16, 16, 4)).astype(np.float32)
    mask = (rng.uniform(size=(2, 16, 16, 1)) > 0.4).astype(np.float32)
    mask_rgb = mask * (rng.uniform(size=(2, 16, 16, 1)) > 0.2)
    convex = y[..., 3:] + 0.1
    classes = np.array([1, -1])
    key = jax.random.PRNGKey(11)

    def run(xp, arr, ints, sampler, fw, extra):
        cond = {"y": arr(y), "mask": arr(mask), "mask_rgb": arr(mask_rgb), "classes": ints(classes)}
        edits = xp.PredX0Edits((0.1, arr(y[..., :3]), arr(mask_rgb)),
                               (0.2, arr(y[..., 3:]), arr(mask)), (0.5, arr(convex)))
        return sampler(fw, *extra, num=2, image_size=16, cond=cond, guidance=2.0,
                       steps=10, eta=0.5, edits=edits)["samples"]

    got = run(tsamp, torch.from_numpy, torch.from_numpy, tsamp.ddim_sample, tfw,
              (JaxReplayNoise(key),))
    want = run(jsamp, jnp.asarray, lambda c: jnp.asarray(c, jnp.int32), jsamp.ddim_sample, jfw,
               (params, key))
    assert rel(got, want) < CHAIN_REL


def test_torch_noise_is_seeded_and_sequential():
    a, b = TorchNoise.seeded(5), TorchNoise.seeded(5)
    x1, x2 = a.split()[1].normal((3,)), a.fold_in(9).normal((3,))
    assert torch.equal(x1, b.normal((3,))) and torch.equal(x2, b.normal((3,)))
    assert not torch.equal(x1, x2)
    assert len(a.split(8)) == 8
    state = a.state_dict()
    u, i = a.uniform((4,)), a.randint((4,), 0, 5)
    assert ((u >= 0) & (u < 1)).all() and ((i >= 0) & (i < 5)).all() and i.dtype == torch.int64
    a.load_state_dict(state)
    assert torch.equal(u, a.uniform((4,))) and torch.equal(i, a.randint((4,), 0, 5))
