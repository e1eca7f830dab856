"""Driver of the ``train_basic`` traffic kind: ``BasicTrainer.run_step`` of
the configuration's ``uncond`` model (no warp: the image and its class are
the whole batch) on procedural RGBD images with class labels.

As the ``train`` kind (:mod:`port_bench.drivers.train`, whose helpers this
reuses): set-up builds the trainer through the program's own classes with
the seeded weights, the benchmark's dataset behind the trainer's own loader
and the benchmark's noise source, runs the first ``check_steps`` steps and
keeps what ``correct`` compares; the window runs steps until ``--seconds``
have passed, a CUDA event after each; every run then profiles
``trace_steps`` more steps, whose device busy time per image is
``train_device_ms_per_image``. The reference follows the first steps from
the same weights, rows, labels and noise
(:func:`port_bench.reference.train_basic.steps`).

Traffic parameters: ``batch`` (rows per step; the configuration's
``batch_size_per_gpu``), ``dataset`` (``length``, ``blobs``; the image size,
near and far are the configuration's; each item's class is drawn from its
index alone, uniform over the model's classes), ``num_workers`` and
``worker_mode`` (the loader's), ``check_steps`` and ``trace_steps``.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from port_bench import device as devices
from port_bench import inputs, trace, weights
from port_bench.drivers import train
from port_bench.noise import Noise
from port_bench.reference import diffusion as ref_diffusion
from port_bench.reference import train as ref_train
from port_bench.reference import train_basic as ref_basic
from port_bench.reference.unet import build_unet

ROLE = "uncond"


def _model(cfg: dict) -> dict:
    return cfg["models"][ROLE]


class LabelledRGBD(inputs.SyntheticRGBD):
    """:class:`port_bench.inputs.SyntheticRGBD` items with a class label
    (``classes``), drawn from the item's index alone."""

    def __init__(self, length: int, image_size: int, blobs: int, near: float, far: float,
                 num_classes: int):
        super().__init__(length, image_size, blobs, near, far, (), 0.0)
        self.labels = [int(inputs.host_rng(11, i).integers(0, num_classes))
                       for i in range(self.length)]

    def __getitem__(self, index: int) -> dict:
        return {"x_0": self.items[index], "classes": np.int64(self.labels[index])}


def dataset(cfg: dict, traffic: dict) -> LabelledRGBD:
    d = _model(cfg)["dataset"]["args"]
    return LabelledRGBD(traffic["dataset"]["length"], d["image_size"],
                        traffic["dataset"]["blobs"], d["near"], d["far"],
                        _model(cfg)["backbone"]["args"]["num_classes"])


def ema_rate(cfg: dict) -> float:
    rate = _model(cfg)["trainer"]["args"]["ema_rate"]
    return float(rate[0] if isinstance(rate, (list, tuple)) else rate)


class Program(train.Program):
    """The program's basic trainer for one cell and what its first steps
    left."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, out_dir: str):
        from ivid_tpu_torch.config import Config, build_backbone, build_framework_from_config
        from ivid_tpu_torch.training.trainer import BasicTrainer

        section = _model(cfg)
        c = Config(**{k: section[k] for k in ("backbone", "framework", "dataset", "trainer")})
        with torch.device(device):
            model = build_backbone(c)
        self.start = weights.draw(section["backbone"]["args"], seed, ROLE, device)
        weights.load(model, self.start)
        fw = build_framework_from_config(c, model, device=device)
        t = section["trainer"]["args"]
        never = 10 ** 12
        self.trainer = BasicTrainer(
            fw, dataset(cfg, traffic), out_dir, max_steps=never,
            batch_size_per_gpu=traffic["batch"], batch_split=t.get("batch_split", 1),
            learning_rate=t["learning_rate"], weight_decay=t.get("weight_decay", 0.0),
            ema_rate=t["ema_rate"], i_print=0, i_log=never, i_sample=never, i_save=never,
            i_ddpcheck=0, sample_at_init=False, num_workers=traffic["num_workers"],
            worker_mode=traffic["worker_mode"], seed=train.loader_seed(seed), device=device,
            noise=Noise.seeded(seed, "trainer", device=device))


def reference_steps(cfg: dict, traffic: dict, seed: int, device, precision: str = "f32",
                    fault=None) -> dict:
    """The reference's first ``check_steps`` steps, as
    :func:`port_bench.drivers.train.reference_steps` reports them. ``fault``,
    when given, is a planted fault (:mod:`port_bench.faults`)."""
    fault = fault or {}
    section = _model(cfg)
    with torch.device(device):
        unet = build_unet(section["backbone"]["args"], precision)
    weights.load(unet, weights.draw(section["backbone"]["args"], seed, ROLE, device))
    fw = ref_diffusion.Framework(section["framework"]["name"], unet,
                                 section["framework"]["args"], device)
    if "framework" in fault:
        fw = fault["framework"](fw)
    data = dataset(cfg, traffic)
    rows = train.first_batches(data, traffic["batch"], seed, traffic["check_steps"])
    batches = [{k: torch.from_numpy(np.stack([data[int(i)][k] for i in r])).to(device)
                for k in ("x_0", "classes")} for r in rows]
    t = section["trainer"]["args"]
    with devices.exact_f32():
        out = ref_basic.steps(fw, dict(unet.named_parameters()), batches,
                              Noise.seeded(seed, "trainer", device=device),
                              lr=t["learning_rate"], weight_decay=t.get("weight_decay", 0.0),
                              ema_rate=ema_rate(cfg), ema=fault.get("ema", ref_train.ema_update))
    host = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
    return {"losses": out["losses"], "grad0": ref_train.leaf_norms(out["grad0"]),
            "mask": host(ref_train.moving_mask(out["grad0"])),
            "change": host(out["change"]), "ema_change": host(out["ema_change"])}


def run(r) -> dict:
    out_dir = tempfile.mkdtemp(prefix="port_bench_train_basic_")
    try:
        return _run(r, r.config, r.traffic, r.device, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _run(r, cfg, traffic, dev, out_dir) -> dict:
    from ivid_tpu_torch.training.trainer import StepRecord

    prog = Program(cfg, traffic, r.seed, dev, out_dir)
    tr = prog.trainer
    try:
        got = prog.first_steps(traffic["check_steps"])
        r.setup_done()

        if r.trace:
            tr.record = StepRecord(timing=True)
        box, marks, losses = [], [], []
        timing = dev.type == "cuda"

        def step():
            losses.append(tr.run_step()["loss"])
            tr.step += 1
            if timing:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()

        devices.reset_peak(dev)
        t0 = time.perf_counter()
        if timing:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        while time.perf_counter() - t0 < r.seconds:
            step()
        devices.sync(dev)
        window_s = time.perf_counter() - t0
        peak_window = devices.peak_bytes(dev)
        steps = len(losses)
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        n_traced = traffic["trace_steps"]
        with trace.session(box):
            for _ in range(n_traced):
                step()
        traced = trace.read(box.pop())
        failed = sum(int(not bool(torch.isfinite(x))) for x in losses[:steps])
        b = traffic["batch"]
        model = _model(cfg)["backbone"]["args"]
        facts = {"window_s": window_s, "steps": steps, "images": steps * b,
                 "step_ms": step_ms, "peak_mem_window": peak_window,
                 "forwards": [{"backbone": model, "batch": b, "count": steps, "passes": 3}],
                 "trace": traced,
                 "traced": {"steps": n_traced, "forwards": [
                     {"backbone": model, "batch": b, "count": n_traced, "passes": 3}]}}
        if tr.record is not None:
            facts["stage_ms"] = tr.record.stage_ms()[:steps]
            facts["loader_waits"] = tr.record.loader_waits[:steps]
        busy_s = traced.busy_s if traced is not None else 0.0
        if busy_s > 0:
            metrics = {"train_device_ms_per_image": 1e3 * busy_s / (n_traced * b)}
        elif timing:
            raise RuntimeError("the profiler recorded no device activity in the traced steps")
        else:
            metrics = {}
        r.memory_peak()
    finally:
        prog.close()
    del prog, tr
    devices.release(dev)
    ref = reference_steps(cfg, traffic, r.seed, dev)
    return {"metrics": metrics, "facts": facts, "readings": train.readings(got, ref),
            "attempted": steps, "failed": failed}
