"""Data-parallel training of the port on the CPU: two gloo ranks launched by
``torch.distributed.run`` through ``python -m ivid_tpu_torch.train
--distributed``, held to one rank at the same global batch.

The run: the single-category cond config cut to a 16² f32 UNet, on a PNG
SingleCategoryWarp folder, InpaintTrainer at global batch 4 (2 rows per
rank), the warp synthesized in the step. Every rank derives the step's
noise for the global batch and keeps its rows, so the two runs take the same
steps up to f32 sum order: the gradients are the mean of two half-batch
means instead of one batch mean, and the warp raster sums its ties over 2
samples instead of 4. After 2 and 3 AdamW steps (lr 1e-4) the parameters
and the EMAs, each taken as one vector, are held within 1e-6 relative L2,
and every element within 1e-7 absolutely (0.1% of a step of lr): the
freshly zeroed output convolutions hold nothing but ~7e-5 of steps, whose
f32 roundings differ by ~4e-9 (1e-6 of their own norm).
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch
import torch.multiprocessing as mp

from ivid_tpu_torch import parallel, train
from ivid_tpu_torch.diffusion.noise import KeyedNoise
from ivid_tpu_torch.training import checkpoint as ckpt_io

from test_torch_data_files import tiny_cond_config, write_folder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "rgbd_singlecategory_adm_128_small_cond"
PARAM_REL, PARAM_ABS = 1e-6, 1e-7


def _torchrun(argv, nproc=2, timeout=120):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", "ivid_tpu_torch.train", *argv, "--device", "cpu",
           "--distributed"]
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _state(run_dir, step):
    return {"model": ckpt_io.load(ckpt_io.model_path(run_dir, step)),
            "ema": ckpt_io.load(ckpt_io.ema_path(run_dir, 0.9999, step))}


def _assert_close(got, want):
    for part in ("model", "ema"):
        assert got[part].keys() == want[part].keys()
        a = torch.cat([got[part][k].reshape(-1) for k in want[part]])
        b = torch.cat([v.reshape(-1) for v in want[part].values()])
        assert float((a - b).norm() / b.norm()) <= PARAM_REL, part
        assert float((a - b).abs().max()) <= PARAM_ABS, part


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One rank at global batch 4 for 3 steps (in this process) and two
    ranks for 2 steps (torchrun), checkpoints at every step."""
    tmp = tmp_path_factory.mktemp("ddp")
    data = write_folder(tmp / "data", "single", n=8)
    config = tiny_cond_config(tmp, i_save=1, i_ddpcheck=1, num_workers=1)
    common = ["--config", config, "--data_dir", data]
    torch.set_num_threads(2)
    one = str(tmp / "one")
    with open(config) as f:
        cfg = json.load(f)
    cfg["trainer"]["args"]["batch_size_per_gpu"] = 4
    one_config = tmp / "one_rank" / f"{NAME}.json"
    one_config.parent.mkdir()
    one_config.write_text(json.dumps(cfg))
    train.main(["--config", str(one_config), "--data_dir", data, "--output_dir", one,
                "--max_steps", "3", "--device", "cpu"])
    two = str(tmp / "two")
    stdout = _torchrun(common + ["--output_dir", two, "--max_steps", "2"])
    return {"one": os.path.join(one, NAME), "two": os.path.join(two, NAME), "common": common,
            "two_root": two, "stdout": stdout}


def test_two_ranks_equal_one_rank_and_only_rank0_writes(runs):
    _assert_close(_state(runs["two"], 2), _state(runs["one"], 2))
    with open(os.path.join(runs["two"], "command.txt")) as f:
        assert len(f.read().splitlines()) == 1
    with open(os.path.join(runs["two"], "log.txt")) as f:
        assert [line.split(":")[0] for line in f] == ["1", "2"]
    assert runs["stdout"].count("Trainer initialized.") == 1
    assert "ranks: 2" in runs["stdout"] and "Batch size: 4 (2 per rank)" in runs["stdout"]
    assert sorted(os.listdir(os.path.join(runs["two"], "ckpts"))) == sorted(
        f"{kind}_step000000{s}.pt" for s in (1, 2) for kind in ("model", "misc", "ema_0.9999"))


def test_resume_from_a_two_rank_checkpoint(runs):
    out = _torchrun(runs["common"] + ["--output_dir", runs["two_root"], "--max_steps", "3",
                                      "--ckpt", "latest"])
    assert "Resumed from step 2" in out
    _assert_close(_state(runs["two"], 3), _state(runs["one"], 3))
    misc = ckpt_io.load(ckpt_io.misc_path(runs["two"], 3))
    assert misc["loader_pos"] == [1, 1] and misc["step"] == 3  # 8 items: 2 batches an epoch


def test_row_shards_make_up_the_global_draw():
    base = KeyedNoise.seeded(3)
    whole = base.fold_in(1).normal((4, 3))
    rows = [parallel.RowShardNoise(base, r, 2).fold_in(1).normal((2, 3)) for r in (0, 1)]
    assert torch.equal(torch.cat(rows), whole) and not torch.equal(rows[0], rows[1])
    assert torch.equal(parallel.RowShardNoise(base, 1, 2).uniform(()), base.uniform(()))


def _replication_rank(rank, port, out_dir):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2", LOCAL_RANK=str(rank))
    parallel.init_from_env("cpu")
    try:
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Linear(4, 2))
        parallel.check_replication(model.named_parameters())
        if rank == 1:
            with torch.no_grad():
                model[1].bias[0] += 1e-7
        try:
            parallel.check_replication(model.named_parameters())
            message = "passed"
        except RuntimeError as e:
            message = str(e)
        with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
            f.write(message)
    finally:
        parallel.shutdown()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_check_replication_names_a_perturbed_parameter(tmp_path):
    ctx = mp.start_processes(_replication_rank, args=(_free_port(), str(tmp_path)), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 60
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            assert time.monotonic() < deadline, "the ranks did not finish within 60 s"
    finally:
        for p in ctx.processes:
            p.kill()
    for rank in (0, 1):
        text = (tmp_path / f"rank{rank}.txt").read_text()
        assert text.startswith("parameter 1.bias differs across ranks"), text
