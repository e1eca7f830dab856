"""Tensor parallelism of the port on larger meshes (CPU, gloo): four ranks at
data 2 × model 2 against one rank, and a TP=2 step against the JAX
package's ``BasicTrainer(model_parallel=2)``.

- Data 2 × model 2 (``torch.distributed.run``, ``python -m
  ivid_tpu_torch.train --distributed --model_parallel 2``): the run of
  ``test_torch_tensor_parallel.py`` at global batch 4, 2 rows per data rank.
  Besides the row-parallel sums, the gradients are the mean of two
  half-batch means and the warp raster sums its ties over 2 samples, as in
  the DP test: the same bounds, 1e-6 relative L2 and 1e-7 absolutely, on the
  parameters, EMAs and AdamW's moments after 2 and 3 steps.
- JAX (conftest's 8 CPU devices, a data 4 × model 2 mesh, the parameters
  laid out by ``_param_spec``) against two port ranks at TP=2, from the same
  weights and batch, with the draws made from the JAX keys in this process
  (``JaxReplayNoise``, recorded here and replayed by the ranks):
  ``test_torch_training.py``'s tolerances, the loss within 1e-5 relative
  and its one-AdamW-step rule for the parameters and the EMA. The JAX
  trainer then reads the port's TP=2 checkpoint, written as ``.msgpack``,
  bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ivid_tpu.data import SyntheticRGBD as JSyntheticRGBD
from ivid_tpu.diffusion import build_framework as jax_framework
from ivid_tpu.models import build_adm_unet as jax_build
from ivid_tpu.training.trainer import BasicTrainer as JBasicTrainer
from ivid_tpu_torch import parallel
from ivid_tpu_torch.data import SyntheticRGBD
from ivid_tpu_torch.diffusion.frameworks import build_framework as torch_framework
from ivid_tpu_torch.models import adm
from ivid_tpu_torch.training import checkpoint as ckpt_io
from ivid_tpu_torch.training import flax_msgpack
from ivid_tpu_torch.training.trainer import BasicTrainer

from test_torch_data_files import tiny_cond_config, write_folder
from test_torch_diffusion import JaxReplayNoise
from test_torch_tensor_parallel import (NAME, assert_close, one_rank_run, spawn_ranks, state,
                                        torchrun)
from test_torch_training import ARCH_KEYS, BACKBONE, DATA, FW, _batch, _flat, _flax

torch.set_num_threads(2)


def test_data2_by_model2_equals_one_rank(tmp_path):
    data = write_folder(tmp_path / "data", "single", n=8)
    config = tiny_cond_config(tmp_path, i_save=1, i_ddpcheck=1, num_workers=1,
                              batch_size_per_gpu=2)
    one, _, _ = one_rank_run(tmp_path, data, config)
    out = torchrun(["--config", config, "--data_dir", data, "--output_dir",
                    str(tmp_path / "mesh"), "--max_steps", "3", "--model_parallel", "2"], nproc=4)
    assert "Mesh: {data: 2, model: 2}" in out and "Batch size: 4 (2 per rank)" in out
    for step in (2, 3):
        assert_close(state(str(tmp_path / "mesh" / NAME), step), state(one, step))


class RecordedNoise:
    """A noise source that records the draws of ``base`` by their derivation
    path, or, without ``base``, replays recorded ones: the JAX keys' draws
    carried to ranks that do not run JAX."""

    def __init__(self, base=None, store=None, path=()):
        self.base, self.store, self.path = base, {} if store is None else store, path

    def split(self, num=2):
        bases = self.base.split(num) if self.base is not None else (None,) * num
        return tuple(RecordedNoise(b, self.store, self.path + ("split", num, i))
                     for i, b in enumerate(bases))

    def fold_in(self, i):
        return RecordedNoise(None if self.base is None else self.base.fold_in(i), self.store,
                             self.path + ("fold_in", i))

    def _draw(self, kind, shape, *args):
        key = self.path + (kind, tuple(shape)) + args
        if self.base is not None:
            self.store[key] = getattr(self.base, kind)(shape, *args)
        return self.store[key]

    def normal(self, shape):
        return self._draw("normal", shape)

    def uniform(self, shape):
        return self._draw("uniform", shape)

    def randint(self, shape, low, high):
        return self._draw("randint", shape, low, high)


def _port_tp_rank(rank, port, work):
    """One of two ranks: the port's BasicTrainer at TP=2 from the weights in
    ``work``, one step on the batch there with the recorded draws, then the
    trainer's own (collective) checkpoint of step 1."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2", LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    parallel.init_from_env("cpu")
    try:
        inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        model = adm.build_adm_unet(BACKBONE)
        model.load_state_dict(inputs["weights"])
        tr = BasicTrainer(torch_framework("ClassifierFreeGuidance", model, FW),
                          SyntheticRGBD(**DATA), os.path.join(work, "port"), max_steps=4,
                          batch_size=8, ema_rate=[0.9], i_log=2, i_sample=10 ** 9,
                          i_save=10 ** 9, sample_at_init=False, model_parallel=2,
                          num_workers=1, device="cpu")
        try:
            metrics = tr._train_step(tr._device_batch(inputs["batch"]),
                                     RecordedNoise(store=inputs["draws"]))
            tr.step = 1
            tr.save()
        finally:
            tr.close()
        if rank == 0:
            with open(os.path.join(work, "loss.json"), "w") as f:
                json.dump({"loss": float(metrics["loss"]), "shards": len(tr.tp_specs),
                           "mesh": [tr.data_size, tr.groups.model_size]}, f)
    finally:
        parallel.shutdown()


def test_tp_step_matches_the_jax_trainers_model_parallel_step(tmp_path):
    """One step of the JAX ``BasicTrainer(model_parallel=2)`` against two
    port ranks at TP=2: AdamW with optax's defaults, then the EMA."""
    port_model = adm.randomize_parameters(adm.build_adm_unet(BACKBONE), 6)
    jtr = JBasicTrainer(
        jax_framework("ClassifierFreeGuidance", jax_build(BACKBONE), FW),
        JSyntheticRGBD(**DATA), str(tmp_path / "jax"), max_steps=4, batch_size=8,
        ema_rate=[0.9], i_log=2, i_sample=10 ** 9, i_save=10 ** 9, sample_at_init=False,
        model_parallel=2,
    )
    assert dict(jtr.mesh.shape) == {"data": 4, "model": 2}
    p0 = _flax(port_model, BACKBONE)
    start = _flat(p0)  # the step donates its inputs
    jtr.params = jax.device_put(p0, jtr.param_sharding)
    jtr.opt_state = jax.device_put(jtr.tx.init(p0), jtr._opt_sharding)
    assert not all(jax.tree.leaves(jax.tree.map(lambda p: p.sharding.is_fully_replicated,
                                                jtr.params)))
    ema0 = jax.tree.map(jnp.array, p0)
    batch = _batch()
    key = jax.random.PRNGKey(9)
    params, opt_state, (ema,), metrics = jtr._step_fn(
        jtr.params, jtr.opt_state, [ema0], key, jtr._global_batch(batch))

    # The draws of the JAX keys, recorded along the port's derivation (the
    # framework's loss on the batch), for the ranks to replay.
    recorder = RecordedNoise(JaxReplayNoise(key))
    rng_prep, rng_loss = recorder.split()
    fw = torch_framework("ClassifierFreeGuidance", adm.build_adm_unet(BACKBONE), FW)
    with torch.no_grad():
        fw.training_loss(rng_loss, {"x_0": torch.from_numpy(batch["x_0"]),
                                    "classes": torch.from_numpy(batch["classes"]).long()})
    work = str(tmp_path / "work")
    os.makedirs(work)
    torch.save({"weights": port_model.state_dict(), "batch": batch, "draws": recorder.store},
               os.path.join(work, "inputs.pt"))
    spawn_ranks(_port_tp_rank, 2, work)
    with open(os.path.join(work, "loss.json")) as f:
        report = json.load(f)
    assert report["mesh"] == [1, 2] and report["shards"] > 0
    assert abs(report["loss"] - float(metrics["loss"])) <= 1e-5 * float(metrics["loss"])

    run_dir = os.path.join(work, "port")
    sd = ckpt_io.load(ckpt_io.model_path(run_dir, 1))
    ema_sd = ckpt_io.load(ckpt_io.ema_path(run_dir, 0.9, 1))
    arch = {k: BACKBONE[k] for k in ARCH_KEYS}
    got = _flat(jax.tree.map(jnp.asarray, ckpt_io.state_dict_to_flax(sd, **arch)))
    got_ema = _flat(jax.tree.map(jnp.asarray, ckpt_io.state_dict_to_flax(ema_sd, **arch)))
    want = _flat(params)
    # AdamW's first step is lr·g/(|g|+eps): a full step of lr = 1e-4 unless
    # |g| is within ~1000 eps of 0, where the two frameworks' roundings decide.
    close = total = 0
    assert got.keys() == want.keys()
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

    # The JAX trainer reads the TP=2 checkpoint as a JAX run's .msgpack files.
    misc = ckpt_io.load(ckpt_io.misc_path(run_dir, 1))
    names = list(sd)
    moments = {m: {names[i]: s[m] for i, s in misc["optimizer"]["state"].items()}
               for m in ("exp_avg", "exp_avg_sq")}
    jax_dir = str(tmp_path / "as_jax")
    os.makedirs(os.path.join(jax_dir, "ckpts"))
    flax_msgpack.write(ckpt_io.model_path(jax_dir, 1, ckpt_io.MSGPACK),
                       ckpt_io.state_dict_to_flax(sd, **arch))
    flax_msgpack.write(ckpt_io.ema_path(jax_dir, 0.9, 1, ckpt_io.MSGPACK),
                       ckpt_io.state_dict_to_flax(ema_sd, **arch))
    flax_msgpack.write(ckpt_io.misc_path(jax_dir, 1, ckpt_io.MSGPACK), ckpt_io.jax_misc(
        step=1, adam_step=1, exp_avg=moments["exp_avg"], exp_avg_sq=moments["exp_avg_sq"],
        rng=[0, 9], loader_pos=[0, 1], ema_rates=[0.9], arch_args=arch))
    jtr.params, jtr.opt_state, jtr.ema_params = params, opt_state, [ema]
    jtr.load(jax_dir, 1)
    assert jtr.step == 1
    loaded = _flat(jtr.params)
    assert all(np.array_equal(loaded[k], got[k]) for k in got)
    mu = _flat(jtr.opt_state[0].mu)
    want_mu = _flat(jax.tree.map(jnp.asarray, ckpt_io.state_dict_to_flax(
        moments["exp_avg"], **arch)))
    assert all(np.array_equal(mu[k], want_mu[k]) for k in want_mu)
