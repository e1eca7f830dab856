"""Data-parallel sampling, the graft entry and the ranks' device rule of the
port (CPU, gloo).

- ``sample.main([... "--data_parallel", "--device", "cpu"])`` on two gloo
  ranks (spawned processes with the launcher's variables), tiny configs (16²
  class-conditional CFG uncond model and InpaintCFG cond model), 4 seeds at
  batch 4, the random viewset with a seeded orbit: rank r samples scenes
  2r and 2r+1 and writes their files. Every row is computed alone, and the
  ranks' noise is their rows of the whole batch's draws, so the samples
  equal one rank's within 1e-5 (f32 products at batch 2 and 4 may take
  other blockings; measured: equal), and the scene files decode to the same
  images (8-bit and 16-bit PNG levels, at most one level apart where a value
  sits on a rounding edge) and the same cameras.
- A batch that the ranks do not divide is refused before any model is built.
- ``graft_entry.dryrun_multichip(2, device="cpu")`` prints the JAX dry run's mesh line;
  ``entry("meta")`` builds the flagship forward's shapes.
- ``parallel.placement``: ``cuda`` is one card per local rank with NCCL
  (refused with too few cards), ``cuda:K`` is gloo on card K, ``cpu`` gloo.
"""

import io
import json
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from ivid_tpu_torch import graft_entry, parallel, sample

from test_torch_tensor_parallel import spawn_ranks
from test_torch_training import BACKBONE

torch.set_num_threads(2)
FW_U = {"timesteps": 100, "beta_schedule": "linear", "p_uncond": 0.1}
FW_C = {**FW_U, "p_uncond_img": 0}
SAMPLES_ABS = 1e-5


def _configs(tmp):
    uncond = {"backbone": {"name": "AdmUnet2d", "args": BACKBONE},
              "framework": {"name": "ClassifierFreeGuidance", "args": FW_U}}
    cond = {"backbone": {"name": "AdmUnet2d", "args": dict(BACKBONE, in_channels=10)},
            "framework": {"name": "InpaintCFG", "args": FW_C}}
    for name, c in (("u.json", uncond), ("c.json", cond)):
        (tmp / name).write_text(json.dumps(c))
    return ["--config_uncond", str(tmp / "u.json"), "--config_cond", str(tmp / "c.json"),
            "--ckpt_uncond", "random", "--ckpt_cond", "random", "--viewset", "random",
            "--steps_uncond", "10", "--steps_cond", "4", "--device", "cpu"]


def seed_orbit(patch):
    """Seed the ``random`` viewset's orbit (drawn from an unseeded generator)
    through ``patch(module, name, value)``, so that runs draw the same one."""
    from ivid_tpu_torch.inference import viewsets

    build = viewsets.build_viewset
    patch(viewsets, "build_viewset", lambda name, n: build(name, n, np.random.default_rng(3)))


def _sample_rank(rank, port, argv, out):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2", LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    seed_orbit(setattr)
    try:
        res = sample.main(argv + ["--data_parallel"])
        np.save(os.path.join(out, f"rank{rank}.npy"), np.concatenate(res["samples"]))
    except ValueError as e:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(str(e))


def _images(path):
    data = np.load(path, allow_pickle=True)["data"]
    return [{k: (imageio.imread(io.BytesIO(v)) if isinstance(v, bytes) else np.asarray(v))
             for k, v in view.items()} for view in data]


def test_two_ranks_sample_the_scenes_of_one(tmp_path, monkeypatch):
    seed_orbit(monkeypatch.setattr)
    argv = _configs(tmp_path) + ["--seeds", "0-3", "--batchsize", "4"]
    one = sample.main(argv + ["--output_dir", str(tmp_path / "one")])
    spawn_ranks(_sample_rank, 2, argv + ["--output_dir", str(tmp_path / "two")], str(tmp_path))
    want = np.concatenate(one["samples"])
    got = np.concatenate([np.load(tmp_path / f"rank{r}.npy") for r in (0, 1)])
    assert want.shape == got.shape == (4, 2, 16, 16, 4)
    np.testing.assert_allclose(got, want, atol=SAMPLES_ABS, rtol=0)
    rel = one["output_dir"][len(str(tmp_path / "one")) + 1:]
    for sub in ("scenes", "conds", "grids", "results"):
        assert (sorted(os.listdir(tmp_path / "one" / rel / sub))
                == sorted(os.listdir(tmp_path / "two" / rel / sub))), sub
    names = sorted(os.listdir(tmp_path / "one" / rel / "scenes"))
    assert len(names) == 4
    for name in names:
        a = _images(tmp_path / "one" / rel / "scenes" / name)
        b = _images(tmp_path / "two" / rel / "scenes" / name)
        assert len(a) == len(b) == 2
        for va, vb in zip(a, b):
            assert va.keys() == vb.keys()
            for k in va:
                if k in ("color", "depth"):
                    assert np.abs(va[k].astype(np.int64) - vb[k]).max() <= 1, (name, k)
                else:
                    np.testing.assert_array_equal(va[k], vb[k], err_msg=f"{name} {k}")


def test_a_batch_the_ranks_do_not_divide_is_refused(tmp_path):
    argv = _configs(tmp_path) + ["--seeds", "0-2", "--batchsize", "4", "--output_dir",
                                 str(tmp_path / "out")]
    spawn_ranks(_sample_rank, 2, argv, str(tmp_path))
    for rank in (0, 1):
        text = (tmp_path / f"rank{rank}.err").read_text()
        assert text.startswith("batches of [3] scenes do not split over 2 ranks"), text


def test_dryrun_multichip_prints_the_mesh_line(capsys):
    line = graft_entry.dryrun_multichip(2, device="cpu")
    assert line.startswith("dryrun_multichip: mesh={'data': 1, 'model': 2} loss=")
    assert line.endswith(" OK") and line in capsys.readouterr().out


def test_entry_builds_the_flagship_forward_on_meta():
    fn, (x, t, classes) = graft_entry.entry("meta")
    assert x.shape == (2, 128, 128, 4) and t.shape == classes.shape == (2,)
    out = fn(x, t, classes)
    assert out.shape == (2, 128, 128, 4) and out.device.type == "meta"


def test_placement_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert parallel.placement("cuda") == ("nccl", torch.device("cuda", 1))
    assert parallel.placement("cuda:0") == ("gloo", torch.device("cuda", 0))
    assert parallel.placement("cpu") == ("gloo", torch.device("cpu"))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(RuntimeError, match="3 local ranks but 2 CUDA devices"):
        parallel.placement("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="1 local ranks but 0 CUDA devices"):
        parallel.placement("cuda")
    with pytest.raises(ValueError, match="not 'mps'"):
        parallel.placement("mps")
