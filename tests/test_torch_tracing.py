"""The port's spans on the profiler's timeline (CPU).

A tiny ``ScenePipeline.sample_batch`` and tiny ``InpaintTrainer`` steps run
under torch.profiler, and every span the CPU path opens must lie inside the
span its layer is called from: the pipeline's batch, views and stages
around the sampler's steps, the UNet's forward, its blocks and the attention
core; the trainer's step around the loader's wait, its stages and the warp
conditioning's three parts. K4's span is checked on the autograd function
with its launchers replaced by their plain versions (the kernels run only on
the card). Without a profiler a span enters no ``record_function``, the
stage clocks keep their keys, and ``sample.py --profile_dir`` writes the
first batch's trace.
"""

import contextlib
import glob
import json
import os

import numpy as np
import pytest
import torch

from ivid_tpu_torch import sample
from ivid_tpu_torch.data import SyntheticRGBDWarp
from ivid_tpu_torch.diffusion.frameworks import build_framework
from ivid_tpu_torch.diffusion.noise import TorchNoise
from ivid_tpu_torch.inference.pipeline import ScenePipeline
from ivid_tpu_torch.inference.viewsets import build_viewset
from ivid_tpu_torch.models import adm
from ivid_tpu_torch.ops import attention as attn
from ivid_tpu_torch.training.trainer import InpaintTrainer, StepRecord
from ivid_tpu_torch.utils import profiling

torch.set_num_threads(2)
# 32² with attention at 32 (1024 tokens, one 64-wide head): the blocks that
# the configs send through ``packed_attention``.
BACKBONE = dict(
    image_size=32, in_channels=4, out_channels=4, model_channels=64,
    num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[32],
    num_groups=8, num_heads=None, num_head_channels=64, num_classes=None,
    has_null_class=False, dropout=0.0, use_fp16=False,
)
FW_U = {"timesteps": 100, "beta_schedule": "linear"}
FW_C = {**FW_U, "p_uncond": 0.1, "p_uncond_img": 0}
PREFIXES = ("pipeline.", "sampler.", "unet.", "attention.", "raster_dense.",
            "raster_tiled.", "trainer.", "warp_cond.")

SAMPLING_PARENTS = {
    "pipeline.sample_batch": None,
    "pipeline.uncond": ("pipeline.sample_batch",),
    "pipeline.mesh": ("pipeline.sample_batch", "pipeline.view"),
    "pipeline.view": ("pipeline.sample_batch",),
    "pipeline.aggregation": ("pipeline.view",),
    "pipeline.cond": ("pipeline.view",),
    "sampler.step": ("pipeline.uncond", "pipeline.cond"),
    "unet.forward": ("sampler.step",),
    "unet.resblock": ("unet.forward",),
    "unet.attnblock": ("unet.forward",),
    "attention.fwd": ("unet.attnblock",),
}
TRAINING_PARENTS = {
    "trainer.step": None,
    "trainer.loader_wait": ("trainer.step",),
    "trainer.data_and_warp": ("trainer.step",),
    "trainer.forward": ("trainer.step",),
    "trainer.backward": ("trainer.step",),
    "trainer.optimizer": ("trainer.step",),
    "warp_cond.presample": ("trainer.data_and_warp",),
    "warp_cond.warp": ("trainer.data_and_warp",),
    "warp_cond.postprocess": ("trainer.data_and_warp",),
    "unet.forward": ("trainer.forward",),
    "unet.resblock": ("unet.forward",),
    "unet.attnblock": ("unet.forward",),
    "attention.fwd": ("unet.attnblock",),
}


def _profiled(fn):
    """``fn()`` under a CPU profiler session; returns its result and the
    program's spans, ``(name, start ns, end ns)`` by start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(PREFIXES)), key=lambda s: s[1])
    return out, spans


def _check_nesting(spans, parents):
    """Every span is one of ``parents``' names, and lies inside a span of
    one of its parents' names (a root inside none of them)."""
    names = {n for n, _, _ in spans}
    assert names == set(parents), (sorted(names - set(parents)), sorted(set(parents) - names))
    for name, s, e in spans:
        allowed = parents[name]
        if allowed is None:
            assert not any(ps <= s and e <= pe for pn, ps, pe in spans
                           if (pn, ps, pe) != (name, s, e) and pn in parents), name
            continue
        assert any(pn in allowed and ps <= s and e <= pe for pn, ps, pe in spans), name


def _count(spans, name):
    return sum(n == name for n, _, _ in spans)


def _pipeline(steps=2):
    pu = adm.randomize_parameters(adm.build_adm_unet(BACKBONE), 0)
    pc = adm.randomize_parameters(adm.build_adm_unet(dict(BACKBONE, in_channels=10)), 1)
    return ScenePipeline(build_framework("GaussianDiffusion", pu, FW_U),
                         build_framework("InpaintCFG", pc, FW_C), image_size=32,
                         steps_uncond=steps, steps_cond=steps, ssaa=1, device="cpu")


def _views(n_views=3):
    return np.asarray(build_viewset("random", 1))[:, :1].repeat(n_views, axis=1)


def _sample_batch(pipe, n_views=3):
    return pipe.sample_batch(TorchNoise.seeded(5), _views(n_views), batch=1)


def _trainer(tmp_path, batch_split=1):
    cfg = dict(BACKBONE, in_channels=10)
    fw = build_framework("InpaintCFG", adm.randomize_parameters(adm.build_adm_unet(cfg), 1),
                         FW_C)
    data = SyntheticRGBDWarp(image_size=32, length=8, num_classes=None, normalize=True,
                             normalize_depth=True, prepocess_depth="z_buffer",
                             augments=["prewarp_noise", "blur", "erode_rgb"])
    return InpaintTrainer(fw, data, str(tmp_path), max_steps=2, batch_size=2,
                          batch_split=batch_split, i_log=1, i_sample=10 ** 9, i_save=10 ** 9,
                          sample_at_init=False, device="cpu")


def test_sample_batch_spans_nest_by_layer():
    """Batch, views and stages around the steps, the UNet's forward, its
    blocks and the attention core: one span per step and per forward."""
    pipe = _pipeline()
    (_, samples, _), spans = _profiled(lambda: _sample_batch(pipe))
    assert samples.shape == (1, 3, 32, 32, 4)
    _check_nesting(spans, SAMPLING_PARENTS)
    assert _count(spans, "pipeline.sample_batch") == 1
    assert _count(spans, "pipeline.view") == 2
    assert _count(spans, "pipeline.mesh") == 3
    assert _count(spans, "pipeline.aggregation") == _count(spans, "pipeline.cond") == 2
    steps = _count(spans, "sampler.step")
    assert steps == 2 + 2 * 2
    assert _count(spans, "unet.forward") == steps
    # Four attention blocks a forward: three at 32² (the input level's one,
    # the output level's two) call ``packed_attention``; the middle block's
    # 256 tokens take the plain form.
    assert _count(spans, "unet.attnblock") == 4 * steps
    assert _count(spans, "attention.fwd") == 3 * steps


@pytest.mark.parametrize("batch_split", [1, 2])
def test_trainer_step_spans_nest_by_stage(tmp_path, batch_split):
    """The step around the loader's wait and the stages, the warp's parts
    in the conditioning; under ``batch_split`` a forward and a backward a
    microbatch."""
    tr = _trainer(tmp_path, batch_split)
    try:
        tr.run_step()  # starts the loader's worker outside the session
        metrics, spans = _profiled(lambda: [tr.run_step(), tr.run_step()])
    finally:
        tr.close()
    assert all(np.isfinite(float(m["loss"])) for m in metrics)
    _check_nesting(spans, TRAINING_PARENTS)
    for name in ("trainer.step", "trainer.loader_wait", "trainer.data_and_warp",
                 "trainer.optimizer", "warp_cond.presample", "warp_cond.warp",
                 "warp_cond.postprocess"):
        assert _count(spans, name) == 2, name
    assert _count(spans, "trainer.forward") == _count(spans, "trainer.backward") == \
        2 * batch_split
    assert _count(spans, "unet.forward") == 2 * batch_split
    # The stages follow one another inside each step.
    order = [n for n, _, _ in spans if n in ("trainer.loader_wait", "trainer.data_and_warp",
                                             "trainer.forward", "trainer.backward",
                                             "trainer.optimizer")]
    one = (["trainer.loader_wait", "trainer.data_and_warp"]
           + ["trainer.forward", "trainer.backward"] * batch_split + ["trainer.optimizer"])
    assert order == one * 2


def test_attention_backward_span_wraps_k4(monkeypatch):
    """``_PackedAttention``'s backward (K4's host preparation and launch)
    is the span ``attention.bwd``, its forward inside ``attention.fwd``;
    the launchers are replaced by their plain versions, so the gradient is
    the plain attention's."""
    calls = []

    def fwd(qkv, heads, scale, with_lse=False):
        return (attn.reference_attention(qkv, heads, scale),
                attn.logsumexp_reference(qkv, heads, scale))

    def bwd(qkv, out, dout, lse, heads, scale):
        calls.append(profiling._profiling())
        return attn.attention_backward_reference(qkv, out, dout, lse, heads, scale)

    monkeypatch.setattr(attn, "_launch", fwd)
    monkeypatch.setattr(attn, "_launch_bwd", bwd)
    qkv = torch.randn(2, 16, 3 * 2 * attn.HEAD_DIM, generator=torch.Generator().manual_seed(0))
    got = qkv.clone().requires_grad_(True)
    want = qkv.clone().requires_grad_(True)

    def run():
        with profiling.span("trainer.forward"):
            with profiling.span("attention.fwd"):
                out = attn._PackedAttention.apply(got, 2, 0.35)
        with profiling.span("trainer.backward"):
            out.square().sum().backward()

    _, spans = _profiled(run)
    attn.reference_attention(want, 2, 0.35).square().sum().backward()
    assert calls == [True]
    torch.testing.assert_close(got.grad, want.grad, rtol=1e-4, atol=1e-5)
    assert _count(spans, "attention.bwd") == 1
    _check_nesting(spans, {"trainer.forward": None, "trainer.backward": None,
                           "attention.fwd": ("trainer.forward",),
                           "attention.bwd": ("trainer.backward",)})


def test_no_profiler_no_record_function(monkeypatch, tmp_path):
    """Without a profiler session a span opens no ``record_function``:
    a whole batch and a training step run with it raising. Inside a
    session the span does open one."""

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _sample_batch(_pipeline(steps=1), n_views=2)
    tr = _trainer(tmp_path)
    try:
        tr.run_step()
    finally:
        tr.close()
    with pytest.raises(AssertionError, match="record_function entered"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.span("pipeline.view"):
                pass


class _Event:
    """A stand-in for a CUDA event on the CPU: ``elapsed_time`` is the
    difference of the order in which events were recorded."""

    clock = 0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        _Event.clock += 1
        self.at = _Event.clock

    def elapsed_time(self, other):
        return float(other.at - self.at)


def test_stage_clocks_keep_their_keys(monkeypatch, tmp_path):
    """The pipeline's ``stage_ms()`` and ``StepRecord.stage_ms()`` keep the
    keys their readers take, with their events recorded in stage order."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    pipe = _pipeline(steps=1)
    pipe._clock.enabled = True
    _sample_batch(pipe, n_views=2)
    # One pair of events a stage call, recorded around it: the first view's
    # and the novel view's mesh lifts add up.
    assert pipe.stage_ms() == {"uncond": 1.0, "mesh": 2.0, "aggregation": 1.0, "cond": 1.0}

    tr = _trainer(tmp_path)
    try:
        rec = StepRecord(timing=True)
        events = tuple(_Event() for _ in range(len(StepRecord.STAGES) + 1))
        events[0].record()
        tr._train_step(tr._device_batch(next(tr.loader)), TorchNoise.seeded(3), events)
        events[-1].record()
        rec.events.append(events)
    finally:
        tr.close()
    (row,) = rec.stage_ms()
    assert list(row) == list(StepRecord.STAGES) + ["step"]
    assert all(row[k] == 1.0 for k in StepRecord.STAGES) and row["step"] == 4.0


def _write_configs(tmp_path):
    small = dict(BACKBONE, image_size=16, model_channels=16, attention_resolutions=[8],
                 num_head_channels=16)
    paths = []
    for name, args, fw in (("u.json", small, ("GaussianDiffusion", FW_U)),
                           ("c.json", dict(small, in_channels=10), ("InpaintCFG", FW_C))):
        cfg = {"backbone": {"name": "AdmUnet2d", "args": args},
               "framework": {"name": fw[0], "args": fw[1]}}
        (tmp_path / name).write_text(json.dumps(cfg))
        paths.append(str(tmp_path / name))
    return ["--config_uncond", paths[0], "--config_cond", paths[1], "--ckpt_uncond", "random",
            "--ckpt_cond", "random", "--output_dir", str(tmp_path / "out"), "--seeds", "0-2",
            "--viewset", "random", "--batchsize", "2", "--steps_uncond", "2",
            "--steps_cond", "2", "--device", "cpu"]


def test_sample_cli_profile_dir(monkeypatch, tmp_path):
    """``--profile_dir`` writes one Chrome trace, of the first batch, with
    the spans in it; without the flag no profiler runs."""
    argv = _write_configs(tmp_path)
    prof = tmp_path / "prof"
    sample.main(argv + ["--profile_dir", str(prof)])
    (path,) = glob.glob(os.path.join(prof, "trace_rank0_*.json"))
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("pipeline.sample_batch") == 1
    assert names.count("sampler.step") == 4 and names.count("unet.forward") == 4

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler ran without --profile_dir")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    result = sample.main(argv)
    assert [s.shape for s in result["samples"]] == [(2, 2, 16, 16, 4), (1, 2, 16, 16, 4)]


def test_span_is_one_shared_no_op_without_profiler():
    """Outside a session ``span`` hands back one shared no-op context (the
    cost a call pays is the check); inside, a fresh ``record_function``."""
    assert not profiling._profiling()
    assert profiling.span("a") is profiling.span("b")
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]))
        assert isinstance(profiling.span("a"), torch.profiler.record_function)
