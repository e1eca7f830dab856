"""The JAX package's checkpoints in the port (CPU): the flax msgpack reader and
writer against flax's own bytes, the converter against the JAX package's,
and sampling, upsampling, finetuning and resuming from files the JAX package
wrote.

Tolerances, and why:
- Reader, writer and converter exactly: they move the same bits (bfloat16
  widened to float32 exactly).
- A UNet forward on the loaded weights vs JAX's ``model.apply`` 1e-5
  relative L2: two f32 UNets agree to ~1e-6 (``test_torch_adm.py``).
- The CLIs on ``.msgpack`` vs ``.pt`` files of the same weights exactly:
  the same weights, the same CPU arithmetic.
- A resumed trainer's state vs the JAX trainer's exactly (the same bits,
  transposed); its next step against JAX's at the trainer-parity
  tolerances of ``test_torch_training.py``.
"""

import collections
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ivid_tpu.data import SyntheticRGBD as JSyntheticRGBD
from ivid_tpu.diffusion import build_framework as jax_framework
from ivid_tpu.models import build_adm_unet as jax_build
from ivid_tpu.models.torch_compat import torch_state_dict_to_flax
from ivid_tpu.training import checkpoint as jckpt
from ivid_tpu.training.trainer import BasicTrainer as JBasicTrainer
from ivid_tpu_torch import sample, sr
from ivid_tpu_torch.config import Config
from ivid_tpu_torch.data import SyntheticRGBD
from ivid_tpu_torch.diffusion.frameworks import build_framework as torch_framework
from ivid_tpu_torch.diffusion.noise import KeyedNoise
from ivid_tpu_torch.models import adm
from ivid_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from ivid_tpu_torch.training import checkpoint as ckpt_io
from ivid_tpu_torch.training import flax_msgpack
from ivid_tpu_torch.training.trainer import BasicTrainer

from test_torch_diffusion import JaxReplayNoise
from test_torch_sr import SMALL as SR_SMALL
from test_torch_sr import _write_config as write_sr_config
from test_torch_sr import _write_scenes as write_sr_scenes
from test_torch_sr import random_flax

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE = dict(
    image_size=16, in_channels=4, out_channels=4, model_channels=16,
    num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[8],
    num_groups=8, num_heads=None, num_head_channels=16, num_classes=3,
    has_null_class=True, dropout=0.0, use_fp16=False,
)
UNCOND = dict(BACKBONE, num_classes=None, has_null_class=False)
FW = {"timesteps": 100, "beta_schedule": "linear", "p_uncond": 0.5}
DATA = dict(image_size=16, length=32, num_classes=3, normalize=True, normalize_depth=True,
            prepocess_depth="z_buffer")
ARCH = ["image_size", "model_channels", "num_res_blocks", "channel_mult",
        "attention_resolutions", "num_classes"]


def arch(cfg):
    return {k: cfg[k] for k in ARCH}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_tree_equal(got, want, path=""):
    """Equal structure, key order, types, dtypes and values; flax's
    bfloat16 leaves against their exact float32 widening."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        want_dtype = np.float32 if want.dtype.name == "bfloat16" else want.dtype
        assert type(got) is (np.ndarray if isinstance(want, np.ndarray) else want_dtype.type), path
        assert got.dtype == want_dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, np.asarray(want).astype(want_dtype), err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# ---- the reader and the writer against flax ----

RNG = np.random.default_rng(0)
Adam = collections.namedtuple("Adam", "count mu nu")
TREES = {
    "f32": {"a": {"kernel": RNG.standard_normal((3, 4, 5)).astype(np.float32)},
            "b": RNG.standard_normal(7).astype(np.float32)},
    "bf16": {"w": np.asarray(jnp.asarray(RNG.standard_normal((4, 33)), jnp.bfloat16)),
             "s": np.asarray(jnp.asarray(-2.75, jnp.bfloat16))},
    "int32": {"i": np.arange(-5, 300, dtype=np.int32).reshape(5, 61)},
    "uint32": {"rng": np.array([0, 2 ** 32 - 1], np.uint32)},
    "int64": {"loader_pos": np.array([3, -2 ** 40], np.int64)},
    "float64": {"ema_rates": np.array([0.9999, 0.5]), "zero_d": np.array(1.25)},
    "numpy scalars": {"f": np.float32(2.5), "i": np.int64(-3), "u": np.uint8(7),
                      "b": np.bool_(True), "d": np.float64(1e-300)},
    "python scalars": {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63 + 5, -1,
                                -32, -33, -128, -129, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 62],
                       "float": 0.1, "bool": False, "none": None, "str": "x" * 40,
                       "long str": "é" * 300, "bytes": b"\x00\x01", "complex": 1.5 - 2j},
    "empty dicts": {"a": {}, "b": {"c": {}}, "empty array": np.zeros((0, 3), np.float32)},
    "nested tuples": {"opt_state": (Adam(np.asarray(3, np.int32),
                                         {"k": np.ones((2, 2), np.float32)},
                                         {"k": np.full((2, 2), 0.5, np.float32)}), (), ()),
                      "deep": (1, (2.0, (np.arange(3),))),
                      "wide": {f"k{i:03d}": np.int32(i) for i in range(90)}},
}


@pytest.mark.parametrize("name", list(TREES))
def test_reader_matches_flax(name):
    """``flax_msgpack.read`` of ``flax.serialization.to_bytes(tree)`` is
    ``msgpack_restore`` of the same bytes: the same tree, types, dtypes and
    values (bfloat16 widened to float32 exactly)."""
    data = serialization.to_bytes(TREES[name])
    assert_tree_equal(flax_msgpack.read(data), serialization.msgpack_restore(data))


def test_reader_reads_a_file_into_writable_views(tmp_path):
    """From a path: one buffer, array leaves are views of it (no copy per
    leaf) and writable, so ``torch.from_numpy`` takes them as they are."""
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.to_bytes(TREES["f32"]))
    tree = flax_msgpack.read(str(path))
    a, b = tree["a"]["kernel"], tree["b"]
    assert a.flags.writeable and a.base is not None and b.base is not None
    assert_tree_equal(tree, serialization.msgpack_restore(path.read_bytes()))


def test_reader_reassembles_chunked_arrays(monkeypatch):
    """flax splits an array above ``MAX_CHUNK_SIZE`` bytes into chunks (the
    limit lowered here, in this test only, so a small array is chunked)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": RNG.standard_normal((7, 9)).astype(np.float32), "small": np.ones(3),
            "nested": {"big64": np.arange(50, dtype=np.int64)}}
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    got = flax_msgpack.read(data)
    assert_tree_equal(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["big"], tree["big"])


def _corrupt(kind):
    data = bytearray(serialization.to_bytes(TREES["f32"]))
    if kind == "truncated in an array":
        return bytes(data[:len(data) // 2])
    if kind == "truncated in a key":
        return bytes(data[:4])
    if kind == "unused type byte":
        data[data.index(b"\xa1b")] = 0xC1
        return bytes(data)
    if kind == "unknown extension":
        data[data.index(b"\x01\x93")] = 9
        return bytes(data)
    if kind == "array of the wrong length":
        i = data.index(b"float32") + len("float32")
        assert data[i] == 0xC4  # bin8: 7 floats
        data[i + 1] -= 4
        return bytes(data)
    return bytes(data) + b"\x00"  # trailing bytes


@pytest.mark.parametrize("kind", ["truncated in an array", "truncated in a key",
                                  "unused type byte", "unknown extension",
                                  "array of the wrong length", "trailing bytes"])
def test_reader_rejects_malformed_bytes(tmp_path, kind):
    """A truncated or corrupted file raises ``ValueError`` naming the file
    and a byte offset."""
    path = tmp_path / "bad.msgpack"
    path.write_bytes(_corrupt(kind))
    with pytest.raises(ValueError, match=r"bad\.msgpack: .* at byte offset \d+"):
        flax_msgpack.read(str(path))


@pytest.mark.parametrize("name", ["f32", "int64", "float64", "numpy scalars", "python scalars",
                                  "empty dicts", "nested tuples"])
def test_writer_writes_flax_bytes(tmp_path, name):
    """``flax_msgpack.write`` writes ``to_bytes``' bytes, which
    ``msgpack_restore`` reads back equal to flax's state dict of the tree."""
    path = tmp_path / "w.msgpack"
    flax_msgpack.write(str(path), TREES[name])
    assert path.read_bytes() == serialization.to_bytes(TREES[name])
    assert_tree_equal(serialization.msgpack_restore(path.read_bytes()),
                      serialization.to_state_dict(TREES[name]))
    assert not (tmp_path / "w.msgpack.tmp").exists()


def test_writer_chunks_as_flax_does(tmp_path, monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"big": RNG.standard_normal((7, 9)).astype(np.float32), "top": np.arange(40)}
    flax_msgpack.write(str(tmp_path / "c.msgpack"), tree)
    data = (tmp_path / "c.msgpack").read_bytes()
    assert data == serialization.to_bytes(tree)
    assert_tree_equal(serialization.msgpack_restore(data), tree)


# ---- the converter ----

def _flagship_cut():
    cfg = Config.load(f"{REPO}/configs/rgbd_imagenet_adm_128_large_cfg.json")
    return dict(cfg.backbone["args"], image_size=32, model_channels=64, num_res_blocks=1,
                channel_mult=[1, 2], attention_resolutions=[32, 16])


def _test_config():
    args = Config.load(f"{REPO}/configs/rgbd_synthetic_adm_32_test.json").backbone["args"]
    return dict(args, num_classes=args["num_classes"])


@pytest.mark.parametrize("cfg", [_test_config, _flagship_cut], ids=["test-32", "flagship-32"])
def test_state_dict_to_flax_equals_torch_compat(cfg):
    """``state_dict_to_flax`` is ``torch_state_dict_to_flax``, leaf for leaf
    and in the same order, bit-equal; ``flax_to_state_dict`` inverts it."""
    cfg = cfg()
    sd = adm.randomize_parameters(adm.build_adm_unet(cfg), 5).state_dict()
    got = state_dict_to_flax(sd, **arch(cfg))
    want = torch_state_dict_to_flax({k: v.numpy() for k, v in sd.items()}, **arch(cfg))
    assert_tree_equal(got, want)
    back = flax_to_state_dict(got, **arch(cfg))
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


# ---- sampling from the JAX package's files ----

@pytest.mark.parametrize("cfg", [UNCOND, BACKBONE], ids=["uncond", "class-cond"])
def test_build_model_on_jax_files_matches_jax_forward(tmp_path, cfg):
    """JAX's ``save_params`` writes a model and an EMA file of a JAX-side
    init (every leaf drawn); the sampling CLI's ``build_model`` loads each,
    and its UNet forward equals JAX's ``model.apply`` of the same params."""
    framework = ({"name": "ClassifierFreeGuidance", "args": FW} if cfg["num_classes"] else
                 {"name": "GaussianDiffusion", "args": {"timesteps": 100, "beta_schedule": "linear"}})
    config = Config(backbone={"name": "AdmUnet2d", "args": cfg}, framework=framework)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16, 16, 4)).astype(np.float32)
    t = np.array([0, 40, 99])
    classes = np.array([0, 2, -1]) if cfg["num_classes"] else None
    jm = jax_build(cfg, dtype=jnp.float32)
    for name, seed in (("model_step0000004.msgpack", 2), ("ema_0.9999_step0000004.msgpack", 3)):
        params = random_flax(cfg, seed)
        jckpt.save_params(str(tmp_path / name), params)
        fw = sample.build_model(config, str(tmp_path / name), 0, torch.device("cpu"))
        got = fw.model(torch.from_numpy(x), torch.from_numpy(t),
                       None if classes is None else torch.from_numpy(classes))
        want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                        None if classes is None else jnp.asarray(classes, jnp.int32))
        assert rel(got.detach().numpy(), want) < 1e-5, name


def _sample_configs(tmp_path):
    u = dict(UNCOND)
    c = dict(UNCOND, in_channels=10)
    for name, args, fw in (("u.json", u, ("GaussianDiffusion", {"timesteps": 100,
                                                                "beta_schedule": "linear"})),
                           ("c.json", c, ("InpaintCFG", {"timesteps": 100,
                                                         "beta_schedule": "linear",
                                                         "p_uncond": 0.1, "p_uncond_img": 0}))):
        (tmp_path / name).write_text(json.dumps({"backbone": {"name": "AdmUnet2d", "args": args},
                                                 "framework": {"name": fw[0], "args": fw[1]}}))
    return u, c


def _both_files(tmp_path, cfg, seed, stem):
    """The same seeded weights as a JAX-written ``.msgpack`` and a ``.pt``."""
    params = random_flax(cfg, seed)
    jckpt.save_params(str(tmp_path / f"{stem}.msgpack"), params)
    torch.save(flax_to_state_dict(jax.device_get(params), **arch(cfg)), tmp_path / f"{stem}.pt")
    return str(tmp_path / f"{stem}.msgpack"), str(tmp_path / f"{stem}.pt")


def test_sample_cli_on_msgpack_equals_pt(tmp_path, monkeypatch):
    """``python -m ivid_tpu_torch.sample`` with ``.msgpack`` checkpoints
    gives the run on ``.pt`` files of the same weights, bit for bit. (The
    ``random`` viewset draws its orbit from an unseeded generator; both runs
    get one seeded alike.)"""
    from ivid_tpu_torch.inference import viewsets

    build = viewsets.build_viewset
    monkeypatch.setattr(viewsets, "build_viewset",
                        lambda name, n: build(name, n, rng=np.random.default_rng(0)))
    u, c = _sample_configs(tmp_path)
    um, up = _both_files(tmp_path, u, 4, "uncond")
    cm, cp = _both_files(tmp_path, c, 5, "cond")
    out = []
    for ckpts, d in (((um, cm), "msgpack"), ((up, cp), "pt")):
        out.append(sample.main([
            "--config_uncond", str(tmp_path / "u.json"), "--config_cond", str(tmp_path / "c.json"),
            "--ckpt_uncond", ckpts[0], "--ckpt_cond", ckpts[1],
            "--output_dir", str(tmp_path / d), "--seeds", "0-1", "--viewset", "random",
            "--batchsize", "2", "--steps_uncond", "4", "--steps_cond", "2", "--device", "cpu",
        ])["samples"])
    assert len(out[0]) == len(out[1]) == 1 and out[0][0].shape == (2, 2, 16, 16, 4)
    assert np.isfinite(out[0][0]).all() and out[0][0].std() > 0
    np.testing.assert_array_equal(out[0][0], out[1][0])


def test_sr_cli_on_msgpack_equals_pt(tmp_path):
    """``python -m ivid_tpu_torch.sr --ckpt_sr x.msgpack`` gives the run on
    the ``.pt`` file of the same weights, bit for bit."""
    write_sr_scenes(tmp_path)
    config = write_sr_config(tmp_path)
    m, p = _both_files(tmp_path, SR_SMALL, 6, "sr")
    out = []
    for ckpt, d in ((m, "msgpack"), (p, "pt")):
        out.append(sr.main(["--config_sr", config, "--ckpt_sr", ckpt, "--scene_dir", str(tmp_path),
                            "--output_dir", str(tmp_path / d), "--steps", "3", "--batchsize", "2",
                            "--device", "cpu"])["samples"])
    assert len(out[0]) == 2 and out[0][0].shape == (2, 32, 32, 4)
    for a, b in zip(*out):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)


def test_finetune_load_pads_a_jax_file_as_jax_does(tmp_path):
    """A JAX-written 4-input ``.msgpack`` for a 10-input cond model: the
    port's ``finetune_load`` equals ``ivid_tpu.training.checkpoint
    .finetune_load``'s padded params after conversion."""
    src = dict(SR_SMALL, in_channels=4)
    cond = dict(SR_SMALL, in_channels=10)
    path = str(tmp_path / "model_step0000010.msgpack")
    jckpt.save_params(path, random_flax(src, 8))
    model = adm.build_adm_unet(cond, dtype=torch.float32)
    got = ckpt_io.finetune_load(path, model.state_dict(), model.arch_args)
    want = flax_to_state_dict(
        jckpt.finetune_load(path, jax.device_get(random_flax(cond, 0)), cond), **arch(cond))
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert got[ckpt_io.IN_CONV].shape[1] == 10 and not got[ckpt_io.IN_CONV][:, 4:].any()
    with pytest.raises(ValueError, match="arch_args"):
        ckpt_io.finetune_load(path, model.state_dict())


@pytest.mark.parametrize("trainer", ["InpaintTrainer", "SuperResTrainer"])
def test_trainers_finetune_from_a_jax_file(tmp_path, trainer):
    """``finetune_ckpt`` of both trainers takes a JAX-written ``.msgpack``:
    the model (and every EMA copy) starts from its padded params, as the
    JAX package's ``finetune_load`` pads them."""
    from ivid_tpu_torch.data import SyntheticRGBDSR, SyntheticRGBDWarp
    from ivid_tpu_torch.training.trainer import TRAINERS

    src = dict(SR_SMALL, in_channels=4)
    cfg = dict(SR_SMALL, in_channels=10 if trainer == "InpaintTrainer" else 8)
    path = str(tmp_path / "ema_0.9999_step0000100.msgpack")
    jckpt.save_params(path, random_flax(src, 9))
    data = dict(image_size=32, length=8, num_classes=3, normalize=True, normalize_depth=True,
                prepocess_depth="z_buffer")
    if trainer == "InpaintTrainer":
        fw, dataset = "InpaintCFG", SyntheticRGBDWarp(**dict(data, num_classes=None))
    else:
        fw, dataset = "SuperResCFG", SyntheticRGBDSR(**dict(data, image_size_lr=16))
    model = adm.build_adm_unet(cfg, dtype=torch.float32)
    tr = TRAINERS[trainer](torch_framework(fw, model, {"timesteps": 100, "p_uncond": 0.1}),
                           dataset, str(tmp_path / "run"), max_steps=1, batch_size=2,
                           sample_at_init=False, device="cpu", num_workers=0,
                           finetune_ckpt=path)
    want = flax_to_state_dict(
        jckpt.finetune_load(path, jax.device_get(random_flax(cfg, 0)), cfg), **arch(cfg))
    got = tr.model.state_dict()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(tr.ema_params[0][k], want[k], rtol=0, atol=0, msg=k)


# ---- resuming a JAX run ----

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX ``BasicTrainer`` run of 2 steps with a save at 2 (batch 8, the
    class-conditional 16² model from seeded weights, EMA 0.9), and its
    trainer."""
    out = tmp_path_factory.mktemp("jax_run")
    jtr = JBasicTrainer(
        jax_framework("ClassifierFreeGuidance", jax_build(BACKBONE), FW),
        JSyntheticRGBD(**DATA), str(out), max_steps=2, batch_size=8, ema_rate=[0.9],
        i_log=2, i_print=0, i_sample=10 ** 9, i_save=2, sample_at_init=False)
    # Seeded weights rather than the fresh init, whose zero output layer
    # leaves most first gradients, and so most moments, at zero.
    p0 = random_flax(BACKBONE, 11)
    jtr.params = jax.device_put(p0, jtr.param_sharding)
    jtr.opt_state = jax.device_put(jtr.tx.init(p0), jtr._opt_sharding)
    jtr.ema_params = [jax.tree.map(jnp.array, p0)]
    jtr.run()
    return str(out), jtr


def _port_trainer(tmp, **kwargs):
    model = adm.build_adm_unet(BACKBONE)
    args = dict(max_steps=4, batch_size=8, ema_rate=[0.9], i_log=2,
                i_sample=10 ** 9, i_save=10 ** 9, sample_at_init=False, device="cpu",
                num_workers=0)
    args.update(kwargs)
    return BasicTrainer(torch_framework("ClassifierFreeGuidance", model, FW),
                        SyntheticRGBD(**DATA), str(tmp), **args)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as_flax(sd):
    return _flat(state_dict_to_flax(sd, **arch(BACKBONE)))


def test_resume_from_a_jax_run_loads_its_state(jax_run, tmp_path, capsys):
    """The port's trainer ``load``s the JAX run's step 2: model, EMA,
    AdamW's ``exp_avg``/``exp_avg_sq``/step, ``trainer.step`` and the
    loader's cursor equal the JAX trainer's; the noise source is the one
    derived from the JAX key, and says so."""
    run_dir, jtr = jax_run
    assert ckpt_io.find_latest_step(run_dir) == 2
    tr = _port_trainer(tmp_path)
    tr.load(run_dir, ckpt_io.find_latest_step(run_dir))
    assert tr.step == jtr.step == 2
    assert tr._loader_obj.position == tuple(int(x) for x in jtr._loader_obj.position)
    assert "JAX PRNG key" in capsys.readouterr().out
    key = [int(w) for w in np.asarray(jtr.rng)]
    assert isinstance(tr.rng, KeyedNoise)
    assert tr.rng.key == KeyedNoise.from_jax_key(key).key != KeyedNoise.seeded(1).key
    want = _flat(jtr.params)
    adam = jtr.opt_state[0]
    pairs = [(tr.model.state_dict(), want), (tr.ema_params[0], _flat(jtr.ema_params[0]))]
    state = [tr.optimizer.state[p] for p in tr.params.values()]
    names = list(tr.params)
    pairs.append(({k: s["exp_avg"] for k, s in zip(names, state)}, _flat(adam.mu)))
    pairs.append(({k: s["exp_avg_sq"] for k, s in zip(names, state)}, _flat(adam.nu)))
    for got, w in pairs:
        got = _as_flax(got)
        assert got.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(got[k], w[k], err_msg=k)
    assert all(float(s["step"]) == int(adam.count) == 2 for s in state)
    # The cursor: the next batch is the one the JAX loader yields next.
    nxt = next(tr.loader)
    want_batch = next(jtr.loader)
    for k in want_batch:
        np.testing.assert_array_equal(nxt[k], want_batch[k], err_msg=k)


def test_resumed_step_matches_the_jax_trainers_next_step(jax_run, tmp_path):
    """One more step after the resume (the same batch, replayed keys)
    against the JAX trainer's next ``_step_fn``: AdamW's third update from
    the loaded moments, then the EMA. Tolerances of
    ``test_trainer_step_with_ema_matches_jax``: every element within two
    steps of lr = 1e-4, 99.9% of them within 1e-6."""
    run_dir, jtr = jax_run
    tr = _port_trainer(tmp_path)
    tr.load(run_dir, 2)
    ds = SyntheticRGBD(**DATA)
    items = [ds[i] for i in range(8, 16)]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    start = _flat(jtr.params)
    ema_start = _flat(jtr.ema_params[0])
    key = jax.random.PRNGKey(21)
    params, _, (ema,), metrics = jtr._step_fn(
        jax.tree.map(jnp.array, jtr.params), jax.tree.map(jnp.array, jtr.opt_state),
        [jax.tree.map(jnp.array, jtr.ema_params[0])], key, jtr._global_batch(batch))
    got_metrics = tr._train_step(tr._device_batch(batch), JaxReplayNoise(key))
    assert abs(float(got_metrics["loss"]) - float(metrics["loss"])) <= 1e-5 * float(metrics["loss"])
    got, want = _as_flax(tr.model.state_dict()), _flat(params)
    got_ema = _as_flax(tr.ema_params[0])
    close = total = 0
    for k in want:
        np.testing.assert_allclose(got_ema[k], 0.9 * ema_start[k] + 0.1 * got[k], atol=1e-8,
                                   rtol=2.4e-7)
        step_t, step_j = got[k] - start[k], want[k] - start[k]
        assert np.abs(step_j).max() > 0, k
        np.testing.assert_allclose(step_t, step_j, atol=2e-4 + 1e-6, rtol=0, err_msg=k)
        close += (np.abs(got[k] - want[k]) <= 1e-6).sum()
        total += got[k].size
    assert close >= 0.999 * total, close / total


def test_jax_misc_has_the_jax_trainers_layout(jax_run, tmp_path):
    """``checkpoint.jax_misc`` (what the card's smoke run writes for a JAX
    run) has the JAX trainer's misc layout: the same keys,
    dtypes and shapes; ``read_jax_misc`` reads it back."""
    run_dir, _ = jax_run
    want = flax_msgpack.read(ckpt_io.misc_path(run_dir, 2, ckpt_io.MSGPACK))
    sd = adm.randomize_parameters(adm.build_adm_unet(BACKBONE), 1).state_dict()
    tree = ckpt_io.jax_misc(step=2, adam_step=2, exp_avg=sd, exp_avg_sq=sd, rng=[7, 9],
                            loader_pos=[0, 16], ema_rates=[0.9], arch_args=arch(BACKBONE))
    path = str(tmp_path / "misc.msgpack")
    flax_msgpack.write(path, tree)
    got = flax_msgpack.read(path)

    def layout(t):
        if isinstance(t, dict):
            return {k: layout(v) for k, v in t.items()}
        return (type(t).__name__, getattr(t, "dtype", None), getattr(t, "shape", None))

    # (The JAX trainer's trees come out of jax.tree.map, with sorted keys.)
    assert (json.dumps(layout(got), default=str, sort_keys=True)
            == json.dumps(layout(want), default=str, sort_keys=True))
    back = ckpt_io.read_jax_misc(path, arch(BACKBONE))
    assert (back["step"], back["adam_step"], back["rng"], back["loader_pos"],
            back["ema_rates"]) == (2, 2, [7, 9], [0, 16], [0.9])
    assert all(torch.equal(back["exp_avg"][k], sd[k]) for k in sd)


def test_find_latest_step_takes_msgpack_and_refuses_both_kinds(jax_run, tmp_path):
    run_dir, _ = jax_run
    assert ckpt_io.find_latest_step(run_dir) == 2
    assert ckpt_io.step_suffix(run_dir, 2) == ".msgpack"
    mixed = tmp_path / "ckpts"
    mixed.mkdir()
    for name in ("model_step0000003.pt", "model_step0000005.msgpack"):
        (mixed / name).write_bytes(b"")
    assert ckpt_io.find_latest_step(str(tmp_path)) == 5
    (mixed / "model_step0000005.pt").write_bytes(b"")
    with pytest.raises(ValueError, match="both"):
        ckpt_io.find_latest_step(str(tmp_path))
    with pytest.raises(ValueError, match="both"):
        ckpt_io.step_suffix(str(tmp_path), 5)
    with pytest.raises(ValueError, match="both"):
        _port_trainer(tmp_path / "run").load(str(tmp_path), 5)


def test_keyed_noise_from_a_jax_key_is_deterministic():
    a = KeyedNoise.from_jax_key([1, 2])
    assert a.key == KeyedNoise.from_jax_key(np.array([1, 2], np.uint32)).key
    assert a.key != KeyedNoise.from_jax_key([2, 1]).key
    assert torch.equal(a.normal((4,)), KeyedNoise.from_jax_key([1, 2]).normal((4,)))
