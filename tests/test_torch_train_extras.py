"""Dropout as the JAX package runs it, and the training CLI's and samplers'
extras (CPU): ``--profile_dir``, ``model_summary.txt`` and the samplers'
``return_trajectory``, each against its JAX counterpart.

Tolerances: the trainer step at the tolerances of
``test_torch_training.py::test_trainer_step_with_ema_matches_jax``; the
trajectories at the sampler tests' chain tolerance (``CHAIN_REL``, 1e-4
relative L2); forwards, sample grids, parameter counts and FLOP counts
exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import test_torch_training
from ivid_tpu.diffusion import build_framework as jax_framework
from ivid_tpu.diffusion import samplers as jsamp
from ivid_tpu.models import build_adm_unet as jax_build
from ivid_tpu.utils.summary import model_summary as jax_model_summary
from ivid_tpu_torch import train
from ivid_tpu_torch.config import Config
from ivid_tpu_torch.diffusion import samplers as tsamp
from ivid_tpu_torch.diffusion.frameworks import build_framework as torch_framework
from ivid_tpu_torch.models import adm
from ivid_tpu_torch.training import trainer as trainer_mod
from ivid_tpu_torch.training.trainer import StepRecord
from ivid_tpu_torch.utils.summary import forward_flops, model_summary

from test_torch_diffusion import BACKBONE, CHAIN_REL, JaxReplayNoise, model_pair, rel

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_CONFIG = os.path.join(REPO, "configs", "rgbd_synthetic_adm_32_test.json")


# ---- F1: dropout only where a caller asks for it ----

def test_trainer_step_at_dropout_matches_jax(tmp_path, monkeypatch):
    """A trainer step of a model with ``dropout`` 0.1 against the JAX
    trainer's (``test_trainer_step_with_ema_matches_jax`` on that config).
    The JAX UNet applies no dropout unless ``deterministic=False``, which no
    caller passes; the port's did in train mode, so this test fails on the
    commit before the repair."""
    monkeypatch.setattr(test_torch_training, "BACKBONE",
                        dict(test_torch_training.BACKBONE, dropout=0.1))
    test_torch_training.test_trainer_step_with_ema_matches_jax(tmp_path, use_fp16=False)


def test_forward_ignores_the_module_mode():
    """At ``dropout`` 0.1 a forward in train mode equals one in eval mode,
    bit for bit; ``deterministic=False`` applies dropout in either mode."""
    cfg = dict(BACKBONE, dropout=0.1)
    model = adm.randomize_parameters(adm.build_adm_unet(cfg), 2)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 4)).astype(np.float32))
    t, classes = torch.tensor([5, 70]), torch.tensor([1, -1])
    with torch.no_grad():
        train_out = model.train()(x, t, classes)
        eval_out = model.eval()(x, t, classes)
        dropped = model.eval()(x, t, classes, deterministic=False)
    assert torch.equal(train_out, eval_out)
    assert not torch.equal(dropped, eval_out)


def test_sample_grid_at_dropout_equals_an_eval_mode_sample(tmp_path, monkeypatch):
    """The trainer samples its grids with the model in train mode, as it
    leaves it; at ``dropout`` 0.1 the grid equals the one sampled in eval
    mode."""
    grids = []
    monkeypatch.setattr(trainer_mod, "save_image_grid",
                        lambda path, x, **kw: grids.append((os.path.basename(path), x.copy())))
    cfg = dict(test_torch_training.BACKBONE, dropout=0.1)
    tr = test_torch_training._port_trainer(tmp_path, cfg, seed=3)
    tr.framework = torch_framework("ClassifierFreeGuidance", tr.model,
                                   dict(test_torch_training.FW, timesteps=40))
    assert tr.model.training
    tr.sample(suffix="a", num_samples=4, batch_size=4)
    tr.model.eval()
    tr.sample(suffix="a", num_samples=4, batch_size=4)
    assert [n for n, _ in grids] == ["rgb_a.png", "depth_a.png"] * 2
    for (_, a), (_, b) in zip(grids[:2], grids[2:]):
        assert np.isfinite(a).all() and a.std() > 0
        np.testing.assert_array_equal(a, b)


# ---- 13b: --profile_dir and model_summary.txt ----

def _cli_config(tmp_path):
    with open(TEST_CONFIG) as f:
        cfg = json.load(f)
    cfg["trainer"]["args"].update(sample_at_init=False, i_save=10 ** 9, i_log=1)
    path = tmp_path / os.path.basename(TEST_CONFIG)
    path.write_text(json.dumps(cfg))
    return str(path)


def test_train_cli_profile_dir_and_model_summary(tmp_path):
    """``--profile_dir`` runs 3 real steps under torch.profiler (counted in
    ``trainer.step``) and writes a Chrome trace that parses; the run
    directory gets ``model_summary.txt``, its total the model's parameter
    count."""
    rec = StepRecord()
    prof = tmp_path / "prof"
    tr = train.main(["--config", _cli_config(tmp_path), "--output_dir", str(tmp_path / "out"),
                     "--max_steps", "3", "--device", "cpu", "--profile_dir", str(prof)],
                    record=rec)
    assert tr.step == 3 and len(rec.losses) == 3
    assert all(np.isfinite(float(x)) for x in rec.losses)
    traces = sorted(os.listdir(prof))
    assert len(traces) == 1 and traces[0].startswith("trace_rank0_") and traces[0].endswith(".json")
    with open(prof / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::convolution" in str(e.get("name")) for e in events)
    text = (tmp_path / "out" / "rgbd_synthetic_adm_32_test" / "model_summary.txt").read_text()
    n_params = sum(p.numel() for p in tr.model.parameters())
    assert f"Total params: {n_params:,} (" in text
    assert "Forward FLOPs (torch.utils.flop_counter" in text
    # run() takes no step after the 3 profiled ones, so it logs none.
    assert not (tmp_path / "out" / "rgbd_synthetic_adm_32_test" / "log.txt").read_text()


def _summary_total(text):
    line = next(ln for ln in text.splitlines() if ln.startswith("Total params: "))
    return int(line.split()[2].replace(",", ""))


def test_model_summary_total_equals_the_jax_summary():
    """The same config's parameter total in the port's and the JAX
    package's ``model_summary`` (the groups differ: top-level modules here,
    top-level flax names there)."""
    cfg = Config.load(TEST_CONFIG).backbone["args"]
    model = adm.build_adm_unet(cfg)
    example = (torch.zeros((1, 32, 32, 4)), torch.zeros((1,), dtype=torch.long),
               torch.zeros((1,), dtype=torch.long))
    got = model_summary(model, example)
    jm = jax_build(cfg)
    jex = (jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    params = jm.init(jax.random.PRNGKey(0), *jex)["params"]
    want = jax_model_summary(jm, params, jex, flops=1.0)
    assert _summary_total(got) == _summary_total(want) == sum(p.numel() for p in model.parameters())
    groups = {ln.split()[0]: int(ln.split()[1].replace(",", "")) for ln in got.splitlines()[2:8]}
    assert list(groups) == ["time_embed", "label_emb", "input_blocks", "middle_block",
                            "output_blocks", "out"]
    assert sum(groups.values()) == _summary_total(got)


@pytest.mark.parametrize("classes", [False, True], ids=["uncond", "classes"])
def test_forward_flops_on_meta_equal_a_cpu_forward(classes):
    """The summary counts FLOPs on the meta device (no arithmetic); the
    count equals ``FlopCounterMode`` around a real forward on the CPU."""
    cfg = dict(BACKBONE, num_classes=3 if classes else None, has_null_class=classes)
    model = adm.randomize_parameters(adm.build_adm_unet(cfg), 0)
    example = (torch.zeros((1, 16, 16, 4)), torch.zeros((1,), dtype=torch.long),
               torch.zeros((1,), dtype=torch.long) if classes else None)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(*example)
    assert forward_flops(model, example) == counter.get_total_flops() > 0


# ---- 13b: the samplers' trajectories ----

def test_ddpm_trajectory_matches_jax():
    """``return_trajectory``: ``pred_x_t`` and ``pred_x_0`` stacked
    ``[T, B, ...]`` in the JAX scan's order, with replayed keys."""
    cfg = dict(BACKBONE, num_classes=None, has_null_class=False)
    port, jm, params = model_pair(cfg, 1)
    fa = {"timesteps": 50, "beta_schedule": "linear"}
    key = jax.random.PRNGKey(7)
    got = tsamp.ddpm_sample(torch_framework("GaussianDiffusion", port, fa), JaxReplayNoise(key),
                            num=2, image_size=16, return_trajectory=True)
    want = jsamp.ddpm_sample(jax_framework("GaussianDiffusion", jm, fa), params, key, num=2,
                             image_size=16, return_trajectory=True)
    for k in ("pred_x_t", "pred_x_0"):
        assert got[k].shape == want[k].shape == (50, 2, 16, 16, 4)
        assert rel(got[k], want[k]) < CHAIN_REL, k
    assert torch.equal(got["pred_x_t"][-1], got["samples"])
    plain = tsamp.ddpm_sample(torch_framework("GaussianDiffusion", port, fa), JaxReplayNoise(key),
                              num=2, image_size=16)
    assert list(plain) == ["samples"] and torch.equal(plain["samples"], got["samples"])


def test_ddim_trajectory_matches_jax():
    """Strided guided DDIM with eta > 0 (CFG over classes): the stacks of
    ``pred_x_t`` and ``pred_x_0``, with replayed keys."""
    port, jm, params = model_pair(BACKBONE, 0)
    fa = {"timesteps": 100, "beta_schedule": "linear", "p_uncond": 0.1}
    classes = np.array([0, 2])
    key = jax.random.PRNGKey(4)
    got = tsamp.ddim_sample(torch_framework("ClassifierFreeGuidance", port, fa),
                            JaxReplayNoise(key), num=2, image_size=16,
                            cond={"classes": torch.from_numpy(classes)}, guidance=1.5, steps=10,
                            eta=0.5, return_trajectory=True)
    want = jsamp.ddim_sample(jax_framework("ClassifierFreeGuidance", jm, fa), params, key, num=2,
                             image_size=16, cond={"classes": jnp.asarray(classes, jnp.int32)},
                             guidance=1.5, steps=10, eta=0.5, return_trajectory=True)
    for k in ("pred_x_t", "pred_x_0"):
        assert got[k].shape == want[k].shape == (10, 2, 16, 16, 4)
        assert rel(got[k], want[k]) < CHAIN_REL, k
    assert torch.equal(got["pred_x_t"][-1], got["samples"])
