"""Port ADM UNet vs the JAX package's ``AdmUnet2d`` (f32 on both sides).

- The port's state-dict names are the reference's: ``torch_state_dict_to_flax``
  (the JAX package's converter of reference checkpoints) maps
  ``port.state_dict()`` onto the flax tree, and the port's ``convert`` maps it
  back bit for bit.
- A forward with every parameter drawn from a numpy seed (a fresh init
  outputs exactly zero) matches ``build_adm_unet(..., dtype=float32)`` within
  1e-4 relative L2 and 1e-4 of the output scale per element (f32 accumulation
  order across a few dozen layers), including the 10-channel conditional input
  and class labels with the null class -1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivid_tpu.models import build_adm_unet as jax_build
from ivid_tpu.models.torch_compat import torch_state_dict_to_flax
from ivid_tpu_torch.models import adm
from ivid_tpu_torch.models.convert import flax_to_state_dict
from ivid_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

SMALL = dict(
    image_size=16, in_channels=10, out_channels=4, model_channels=32,
    num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[8],
    num_groups=8, num_heads=None, num_head_channels=16, num_classes=5,
    has_null_class=True, dropout=0.0, use_fp16=False,
)
# 32² with attention at 32 (T=1024, 64-wide heads) takes the packed-kernel
# branch of the attention dispatch; the 16² level takes the plain form.
PACKED = dict(
    image_size=32, in_channels=4, out_channels=4, model_channels=64,
    num_res_blocks=1, channel_mult=[1, 1], attention_resolutions=[32, 16],
    num_groups=32, num_heads=None, num_head_channels=64, num_classes=None,
    has_null_class=False, dropout=0.0, use_fp16=True,
)
ARCH_KEYS = ["image_size", "model_channels", "num_res_blocks", "channel_mult",
             "attention_resolutions", "num_classes"]


def _jax_params(cfg, seed):
    """The flax tree of ``cfg`` with every leaf drawn from a numpy seed."""
    model = jax_build(cfg, dtype=jnp.float32)
    s, c = cfg["image_size"], cfg["in_channels"]
    cl = jnp.zeros((1,), jnp.int32) if cfg["num_classes"] else None
    tree = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, c)), jnp.zeros((1,), jnp.int32), cl
    )["params"])
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return 1.0 + 0.1 * z
        if leaf.ndim >= 2:
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        return 0.05 * z

    return model, jax.tree_util.tree_map_with_path(draw, tree)


def test_state_dict_round_trips_through_the_flax_converter():
    cfg = SMALL
    port = adm.build_adm_unet(cfg)
    adm.randomize_parameters(port, seed=3)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    flax_tree = torch_state_dict_to_flax(sd, **{k: cfg[k] for k in ARCH_KEYS})
    model, want = _jax_params(cfg, seed=0)
    assert (jax.tree_util.tree_structure(flax_tree)
            == jax.tree_util.tree_structure(want))
    shapes = jax.tree.map(lambda a, b: a.shape == b.shape, flax_tree, want)
    assert all(jax.tree.leaves(shapes))
    back = flax_to_state_dict(flax_tree, **{k: cfg[k] for k in ARCH_KEYS})
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("cfg", [SMALL, PACKED], ids=["cond-classes", "packed-dispatch"])
def test_forward_matches_jax(cfg, monkeypatch):
    model, params = _jax_params(cfg, seed=1)
    port = adm.build_adm_unet(cfg, dtype=torch.float32)
    port.load_state_dict(flax_to_state_dict(params, **{k: cfg[k] for k in ARCH_KEYS}))
    port.eval()

    rng = np.random.default_rng(2)
    s, c = cfg["image_size"], cfg["in_channels"]
    x = rng.standard_normal((3, s, s, c)).astype(np.float32)
    t = np.array([0, 37, 999])
    classes = np.array([2, -1, 4]) if cfg["num_classes"] else None

    calls = []
    real = tattn.packed_attention
    monkeypatch.setattr(tattn, "packed_attention",
                        lambda *a: calls.append(a[0].shape[1]) or real(*a))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t),
                   None if classes is None else torch.from_numpy(classes)).numpy()
    want = np.asarray(model.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t, jnp.int32),
        None if classes is None else jnp.asarray(classes, jnp.int32),
    ))
    assert got.shape == want.shape == (3, s, s, 4)
    assert np.abs(want).mean() > 0.1  # every layer reaches the output
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-4, rel
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # Attention dispatch: the kernel wrapper exactly at T >= 512 with 64-wide heads.
    assert calls == ([1024, 1024, 1024] if cfg is PACKED else [])


def test_fresh_model_dtypes():
    """bf16 torso: every parameter is an f32 master weight; the convolutions
    and attention projections compute in bf16, the embedding MLP and the
    output head in f32. A fresh model predicts exactly zero (the reference's
    zero-initialized output layers)."""
    port = adm.build_adm_unet(PACKED)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    seen = {}

    def hook(name):
        return lambda module, args, out: seen.__setitem__(name, out.dtype)

    port.input_blocks[1][0].in_layers[2].register_forward_hook(hook("conv"))
    port.input_blocks[1][0].skip_connection.register_forward_hook(hook("skip"))
    port.input_blocks[1][1].norm.register_forward_hook(hook("attn_norm"))
    port.time_embed[1].register_forward_hook(hook("embed"))
    port.out[2].register_forward_hook(hook("head"))
    x = torch.randn(1, 32, 32, 4)
    with torch.no_grad():
        y = port(x, torch.tensor([5]))
    assert seen == {"conv": torch.bfloat16, "skip": torch.bfloat16, "attn_norm": torch.bfloat16,
                    "embed": torch.float32, "head": torch.float32}
    assert y.dtype == torch.float32 and torch.equal(y, torch.zeros_like(y))
