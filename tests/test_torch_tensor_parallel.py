"""Tensor parallelism of the port on the CPU (``parallel/tensor.py``): two
gloo ranks launched by ``torch.distributed.run`` through ``python -m
ivid_tpu_torch.train --distributed --model_parallel 2``, held to one rank.

The run is ``test_torch_distributed.py``'s: the single-category cond config
cut to a 16² f32 UNet (every residual block and both attention blocks
sharded), on a PNG SingleCategoryWarp folder, InpaintTrainer at global
batch 4, which both model ranks see whole. The two runs take the same steps
up to f32 sum order: a row-parallel layer sums two half-channel partial
products instead of one product. After 2 and 3 AdamW steps the parameters,
the EMAs and AdamW's two moments, each taken as one vector, are held within
1e-6 relative L2, and every element within 1e-7 absolutely, the DP test's
bounds for the same reason (measured at step 3: parameters 2e-9 relative,
moments 8e-8).

Also: the step-2 checkpoint of the TP run (full tensors, the files of a
one-rank run) resumed at TP=1 gives the uninterrupted run's step-3 loss and
state; the same checkpoint written as a JAX package run (``.msgpack``)
resumes alike at TP=2 and at TP=1; the trainer's sample grid, sampled by
both ranks in lockstep and written by rank 0 alone, equal to one rank's;
``shard_unet``'s layout table; and ``check_replication`` on shards.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ivid_tpu_torch import parallel, train
from ivid_tpu_torch.models import adm
from ivid_tpu_torch.parallel import tensor as tp
from ivid_tpu_torch.training import checkpoint as ckpt_io
from ivid_tpu_torch.training import flax_msgpack
from ivid_tpu_torch.training.trainer import StepRecord

from test_torch_data_files import tiny_cond_config, write_folder
from test_torch_distributed import _free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "rgbd_singlecategory_adm_128_small_cond"
PARAM_REL, PARAM_ABS = 1e-6, 1e-7
LOSS_REL = 1e-5
PARTS = ("model", "ema", "exp_avg", "exp_avg_sq")


def torchrun(argv, nproc=2, timeout=180):
    """``python -m ivid_tpu_torch.train ARGV --device cpu --distributed`` on
    ``nproc`` gloo ranks; returns the launcher's stdout."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", "ivid_tpu_torch.train", *argv, "--device", "cpu",
           "--distributed"]
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def state(run_dir, step):
    """The checkpoint of ``step``: model, EMA and AdamW's moments by name."""
    model = ckpt_io.load(ckpt_io.model_path(run_dir, step))
    names = list(model)
    opt = ckpt_io.load(ckpt_io.misc_path(run_dir, step))["optimizer"]["state"]
    return {"model": model, "ema": ckpt_io.load(ckpt_io.ema_path(run_dir, 0.9999, step)),
            "exp_avg": {names[i]: s["exp_avg"] for i, s in opt.items()},
            "exp_avg_sq": {names[i]: s["exp_avg_sq"] for i, s in opt.items()}}


def assert_close(got, want, parts=PARTS):
    for part in parts:
        assert got[part].keys() == want[part].keys(), part
        a = torch.cat([got[part][k].reshape(-1).float() for k in want[part]])
        b = torch.cat([v.reshape(-1).float() for v in want[part].values()])
        assert float((a - b).norm() / b.norm()) <= PARAM_REL, part
        assert float((a - b).abs().max()) <= PARAM_ABS, part


def one_rank_run(tmp, data, config, steps=3):
    """The reference: one rank at global batch 4, ``steps`` steps, a
    checkpoint after each; returns its run directory and losses."""
    with open(config) as f:
        cfg = json.load(f)
    cfg["trainer"]["args"]["batch_size_per_gpu"] = 4
    path = tmp / "one_rank" / f"{NAME}.json"
    path.parent.mkdir()
    path.write_text(json.dumps(cfg))
    rec = StepRecord()
    train.main(["--config", str(path), "--data_dir", data, "--output_dir", str(tmp / "one"),
                "--max_steps", str(steps), "--device", "cpu"], record=rec)
    return str(tmp / "one" / NAME), [float(x) for x in rec.losses], str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One rank for 3 steps (in this process) and two TP ranks for 3 steps
    (torchrun), checkpoints at every step."""
    tmp = tmp_path_factory.mktemp("tp")
    data = write_folder(tmp / "data", "single", n=8)
    config = tiny_cond_config(tmp, i_save=1, i_ddpcheck=1, num_workers=1, batch_size_per_gpu=4)
    torch.set_num_threads(2)
    one, losses, one_config = one_rank_run(tmp, data, config)
    stdout = torchrun(["--config", config, "--data_dir", data, "--output_dir", str(tmp / "tp"),
                       "--max_steps", "3", "--model_parallel", "2"])
    return {"tmp": tmp, "data": data, "config": config, "one": one, "losses": losses,
            "one_config": one_config, "tp": str(tmp / "tp" / NAME), "stdout": stdout}


def test_two_tp_ranks_equal_one_rank(runs):
    for step in (2, 3):
        assert_close(state(runs["tp"], step), state(runs["one"], step))
    assert "Mesh: {data: 1, model: 2}" in runs["stdout"]
    assert "Batch size: 4 (4 per rank)" in runs["stdout"]
    assert runs["stdout"].count("Trainer initialized.") == 1
    # The checkpoints hold full tensors: the files, names and shapes of a
    # one-rank run.
    ckpts = lambda d: sorted(os.listdir(os.path.join(d, "ckpts")))
    assert ckpts(runs["tp"]) == ckpts(runs["one"])
    got, want = state(runs["tp"], 3), state(runs["one"], 3)
    assert {k: v.shape for k, v in got["model"].items()} == {
        k: v.shape for k, v in want["model"].items()}


def test_tp_checkpoint_resumes_at_one_rank(runs, tmp_path):
    """The TP run's step 2 resumed by one rank: the uninterrupted run's
    step-3 loss and state."""
    rec = StepRecord()
    train.main(["--config", runs["one_config"], "--data_dir", runs["data"], "--output_dir",
                str(tmp_path), "--load_dir", runs["tp"], "--ckpt", "2", "--max_steps", "3",
                "--device", "cpu"], record=rec)
    assert len(rec.losses) == 1
    assert abs(float(rec.losses[0]) - runs["losses"][2]) <= LOSS_REL * runs["losses"][2]
    assert_close(state(str(tmp_path / NAME), 3), state(runs["one"], 3))


def test_tp_checkpoint_as_a_jax_run_resumes_alike_at_tp2_and_tp1(runs, tmp_path):
    """The TP run's step 2 written as a JAX package run (``.msgpack``: model,
    EMA, misc with optax's AdamW moments): TP=2 and TP=1 resume it to the
    same step 3 (each derives its noise from the run's JAX key)."""
    src = state(runs["tp"], 2)
    arch = adm.build_adm_unet(json.load(open(runs["config"]))["backbone"]["args"]).arch_args
    jax_dir = str(tmp_path / "jax_run")
    os.makedirs(os.path.join(jax_dir, "ckpts"))
    flax_msgpack.write(ckpt_io.model_path(jax_dir, 2, ckpt_io.MSGPACK),
                       ckpt_io.state_dict_to_flax(src["model"], **arch))
    flax_msgpack.write(ckpt_io.ema_path(jax_dir, 0.9999, 2, ckpt_io.MSGPACK),
                       ckpt_io.state_dict_to_flax(src["ema"], **arch))
    misc = ckpt_io.load(ckpt_io.misc_path(runs["tp"], 2))
    flax_msgpack.write(ckpt_io.misc_path(jax_dir, 2, ckpt_io.MSGPACK), ckpt_io.jax_misc(
        step=2, adam_step=2, exp_avg=src["exp_avg"], exp_avg_sq=src["exp_avg_sq"], rng=[3, 5],
        loader_pos=misc["loader_pos"], ema_rates=[0.9999], arch_args=arch))
    common = ["--data_dir", runs["data"], "--load_dir", jax_dir, "--ckpt", "latest",
              "--max_steps", "3"]
    out = torchrun(["--config", runs["config"], "--output_dir", str(tmp_path / "tp2"),
                    "--model_parallel", "2", *common])
    assert "Resumed from step 2" in out
    train.main(["--config", runs["one_config"], "--output_dir", str(tmp_path / "tp1"),
                "--device", "cpu", *common])
    assert_close(state(str(tmp_path / "tp2" / NAME), 3), state(str(tmp_path / "tp1" / NAME), 3))


def _grid_rank(rank, port, argv, out):
    """One TP rank of ``train.main(argv)`` that records the sample grids it
    writes."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2", LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    written = record_grids(setattr)
    train.main(argv + ["--distributed", "--model_parallel", "2"])
    with open(os.path.join(out, f"grids{rank}.json"), "w") as f:
        json.dump(written, f)


def record_grids(patch):
    """Make the trainer's ``save_image_grid`` (replaced through
    ``patch(module, name, value)``) list the names of the files it writes."""
    from ivid_tpu_torch.training import trainer

    save, written = trainer.save_image_grid, []

    def record(path, *args, **kwargs):
        written.append(os.path.basename(path))
        save(path, *args, **kwargs)

    patch(trainer, "save_image_grid", record)
    return written


def test_tp_sample_grid_equals_one_rank(tmp_path, monkeypatch):
    """The trainer's sample grid at init under TP=2: every rank samples in
    lockstep through the sharded model (seeded random weights through
    ``finetune_ckpt``, so that every layer reaches the output), rank 0 alone
    writes the grids, and they decode to one rank's images (8-bit levels, at
    most one apart where a value sits on a rounding edge; measured: equal)."""
    import imageio.v2 as imageio

    data = write_folder(tmp_path / "data", "single", n=8)
    config = tiny_cond_config(tmp_path, num_workers=1, batch_size_per_gpu=4)
    cfg = json.loads(open(config).read())
    weights = str(tmp_path / "random.pt")
    torch.save(adm.randomize_parameters(adm.build_adm_unet(cfg["backbone"]["args"]), 5)
               .state_dict(), weights)
    cfg["trainer"]["args"].update(sample_at_init=True, finetune_ckpt=weights)
    with open(config, "w") as f:
        json.dump(cfg, f)
    argv = ["--config", config, "--data_dir", data, "--max_steps", "1", "--device", "cpu"]
    torch.set_num_threads(2)
    one = record_grids(monkeypatch.setattr)
    train.main(argv + ["--output_dir", str(tmp_path / "one")])
    spawn_ranks(_grid_rank, 2, argv + ["--output_dir", str(tmp_path / "tp")], str(tmp_path))
    ranks = [json.loads((tmp_path / f"grids{r}.json").read_text()) for r in (0, 1)]
    assert ranks[1] == [] and sorted(ranks[0]) == sorted(one)
    assert len(one) == 8 and all(name.endswith("_init.png") for name in one)
    grids = lambda run: os.path.join(tmp_path, run, NAME, "samples")
    assert sorted(os.listdir(grids("tp"))) == sorted(os.listdir(grids("one"))) == sorted(one)
    for name in one:
        a = imageio.imread(os.path.join(grids("tp"), name)).astype(np.int64)
        b = imageio.imread(os.path.join(grids("one"), name))
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name


TINY = dict(image_size=16, in_channels=10, out_channels=4, model_channels=16,
            num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[8], num_groups=8,
            num_heads=None, num_head_channels=16, num_classes=None, dropout=0.0,
            use_fp16=False)


def expected_layout(model, size):
    """``shard_unet``'s table, written out per block: name -> (dim, halves)."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, adm.ResBlock):
            c = mod.in_layers[2].out_channels
            if c % size == 0 and mod.out_layers[0].num_groups % size == 0:
                for p, dim, halves in (("in_layers.2.weight", 0, False),
                                       ("in_layers.2.bias", 0, False),
                                       ("emb_layers.1.weight", 0, True),
                                       ("emb_layers.1.bias", 0, True),
                                       ("out_layers.0.weight", 0, False),
                                       ("out_layers.0.bias", 0, False),
                                       ("out_layers.3.weight", 1, False)):
                    out[f"{name}.{p}"] = (dim, halves)
        elif isinstance(mod, adm.AttentionBlock) and mod.heads % size == 0:
            out.update({f"{name}.qkv.weight": (0, False), f"{name}.qkv.bias": (0, False),
                        f"{name}.proj_out.weight": (1, False)})
    return out


@pytest.mark.parametrize("size", [2, 4, 3])
def test_shard_unet_layout_table(size):
    """Which parameters are sharded, along which dimension; every rank's
    slices concatenate to the full tensor (the ``emb_layers`` rows of the
    scale half, then of the shift half); replicated parameters unchanged; a
    sharded attention block computes heads/m heads of the same width. At
    m=4 the 2-head attention blocks stay replicated, at m=3 every block."""
    full = adm.randomize_parameters(adm.build_adm_unet(TINY), 0)
    want = expected_layout(full, size)
    assert bool(want) == (size != 3)
    assert any(k.endswith("qkv.weight") for k in want) == (size == 2)
    full_state = {k: v.clone() for k, v in full.state_dict().items()}
    locals_ = []
    for rank in range(size):
        model = copy.deepcopy(full)
        specs = tp.shard_unet(model, parallel.Groups(None, None, 0, 1, rank, size))
        assert {k: (s.dim, s.halves) for k, s in specs.items()} == want
        local = model.state_dict()
        assert local.keys() == full_state.keys()
        for k, v in local.items():
            if k not in specs:
                assert torch.equal(v, full_state[k]), k
        for name, mod in model.named_modules():
            if isinstance(mod, adm.AttentionBlock):
                sharded = f"{name}.qkv.weight" in specs
                assert mod.heads == (2 // size if sharded else 2) and mod.head_dim == 16
                assert mod.qkv.weight.shape[0] == 3 * mod.heads * mod.head_dim
        locals_.append(local)
    for k, (dim, halves) in want.items():
        parts = [loc[k] for loc in locals_]
        assert all(p.shape[dim] * size == full_state[k].shape[dim] for p in parts), k
        assert torch.equal(tp.unshard_tensor(parts, tp.Shard(dim, halves)), full_state[k]), k
        if halves:
            c = full_state[k].shape[0] // 2
            n = c // size
            assert torch.equal(parts[1], torch.cat([full_state[k][n:2 * n],
                                                    full_state[k][c + n:c + 2 * n]]))
    # shard_state_dict cuts a full state dict to a rank's slices.
    specs = tp.shard_unet(copy.deepcopy(full), parallel.Groups(None, None, 0, 1, 1, size))
    cut = tp.shard_state_dict(full_state, specs, parallel.Groups(None, None, 0, 1, 1, size))
    assert all(torch.equal(cut[k], locals_[1][k]) for k in cut)


def test_make_groups_without_a_process_group():
    """One process: the mesh of one rank; tensor parallelism needs ranks."""
    assert parallel.make_groups(1) == parallel.Groups(None, None)
    with pytest.raises(ValueError, match="needs a process group of 2 ranks or more"):
        parallel.make_groups(2)
    with pytest.raises(ValueError, match="must be at least 1"):
        parallel.make_groups(0)


def _shard_check_rank(rank, port, out_dir):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="4", LOCAL_RANK=str(rank))
    parallel.init_from_env("cpu")
    try:
        groups = parallel.make_groups(2)
        shard = torch.nn.Parameter(torch.full((2,), float(groups.model_rank)))
        whole = torch.nn.Parameter(torch.ones(3))
        named = lambda: [("w", whole), ("s", shard)]
        parallel.check_replication(named(), {"s"}, 2)  # shards differ across model ranks
        messages = []
        for bad in ("s", "w"):
            with torch.no_grad():
                if rank == 3:
                    dict(named())[bad][0] += 1e-7
            try:
                parallel.check_replication(named(), {"s"}, 2)
                messages.append("passed")
            except RuntimeError as e:
                messages.append(str(e))
            with torch.no_grad():
                if rank == 3:
                    dict(named())[bad][0] -= 1e-7
        with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
            f.write(json.dumps({"groups": [groups.data_rank, groups.data_size, groups.model_rank,
                                           groups.model_size], "messages": messages}))
    finally:
        parallel.shutdown()


def spawn_ranks(fn, nprocs, *args, timeout=120):
    """``fn(rank, port, *args)`` in ``nprocs`` spawned processes; fails if a
    rank fails or they do not finish within ``timeout`` seconds."""
    ctx = mp.start_processes(fn, args=(_free_port(), *args), nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            assert time.monotonic() < deadline, f"the ranks did not finish within {timeout} s"
    finally:
        for p in ctx.processes:
            p.kill()


def test_make_groups_and_check_replication_on_shards(tmp_path):
    """Four ranks at model 2: rank ``d·2 + m`` sits at ``(d, m)``; a shard
    may differ across model ranks but not within its data group, a
    replicated parameter nowhere."""
    spawn_ranks(_shard_check_rank, 4, str(tmp_path), timeout=60)
    for rank in range(4):
        got = json.loads((tmp_path / f"rank{rank}.txt").read_text())
        assert got["groups"] == [rank // 2, 2, rank % 2, 2]
        shard_msg, whole_msg = got["messages"]
        assert shard_msg.startswith("shard s differs across ranks"), shard_msg
        assert whole_msg.startswith("parameter w differs across ranks"), whole_msg
