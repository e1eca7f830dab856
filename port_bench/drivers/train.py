"""Driver of the ``train`` traffic kind: ``InpaintTrainer.run_step`` of the
configuration's cond model on procedural RGBD images.

Set-up builds the trainer through the program's own classes, with the
seeded weights, the benchmark's dataset (:class:`port_bench.inputs.
SyntheticRGBD`) behind the trainer's own loader, and the benchmark's noise
source; it then runs the first ``check_steps`` steps through ``run_step``
(which also warms up every shape) and keeps what ``correct`` compares: the
first gradient as AdamW holds it after one step (its first moment over
1 - beta1), and the change of the parameters and of their EMA after the
last of them (moved to the host, so the window's memory is the program's).
The same trainer then runs the window: steps until ``--seconds`` have passed
on the host clock, a CUDA event recorded after each (the step times of
``trainer.step_ms_p90.train``), no synchronisation until the window
closes; its images over its seconds are ``trainer.images_per_s.train``.
Every run then profiles ``trace_steps`` more steps: the device's busy time
over them (the union of its activity) per image is the end-to-end
``train_device_ms_per_image``, and the traced run's readers take their
kernels from the same trace. The reference follows the first steps from the
same weights, rows and noise (:func:`port_bench.reference.train.steps`).

Traffic parameters: ``batch`` (rows per step; the configuration's
``batch_size_per_gpu``), ``dataset`` (``length``, ``blobs``; the image size,
near, far and augments are the configuration's), ``pose_std``,
``num_workers`` and ``worker_mode`` (the loader's), ``check_steps`` and
``trace_steps`` (how many steps every run profiles after its window).
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from port_bench import device as devices
from port_bench import inputs, trace, weights
from port_bench.noise import Noise
from port_bench.reference import diffusion as ref_diffusion
from port_bench.reference import train as ref_train
from port_bench.reference.unet import build_unet

BETA1 = 0.9


def _model(cfg: dict) -> dict:
    return cfg["models"]["cond"]


def loader_seed(seed: int) -> int:
    return int(seed) % (2 ** 31)


def dataset(cfg: dict, traffic: dict) -> inputs.SyntheticRGBD:
    d = _model(cfg)["dataset"]["args"]
    return inputs.SyntheticRGBD(traffic["dataset"]["length"], d["image_size"],
                                traffic["dataset"]["blobs"], d["near"], d["far"],
                                d.get("augments", ()), traffic["pose_std"])


def first_batches(data, batch: int, seed: int, steps: int) -> list:
    """The rows of the trainer's first ``steps`` batches: the loader's first
    epoch, a permutation of the items drawn from its seed
    (``np.random.default_rng(seed).permutation``), cut into batches."""
    order = np.random.default_rng(loader_seed(seed)).permutation(len(data))
    return [order[k * batch:(k + 1) * batch] for k in range(steps)]


class Program:
    """The program's trainer for one cell and what its first steps left."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, out_dir: str):
        from ivid_tpu_torch.config import Config, build_backbone, build_framework_from_config
        from ivid_tpu_torch.training.trainer import InpaintTrainer

        section = _model(cfg)
        c = Config(**{k: section[k] for k in ("backbone", "framework", "dataset", "trainer")})
        with torch.device(device):
            model = build_backbone(c)
        self.start = weights.draw(section["backbone"]["args"], seed, "cond", device)
        weights.load(model, self.start)
        fw = build_framework_from_config(c, model, device=device)
        t = section["trainer"]["args"]
        never = 10 ** 12
        self.trainer = InpaintTrainer(
            fw, dataset(cfg, traffic), out_dir, max_steps=never,
            batch_size_per_gpu=traffic["batch"], batch_split=t.get("batch_split", 1),
            learning_rate=t["learning_rate"], weight_decay=t.get("weight_decay", 0.0),
            ema_rate=t["ema_rate"], i_print=0, i_log=never, i_sample=never, i_save=never,
            i_ddpcheck=0, sample_at_init=False, num_workers=traffic["num_workers"],
            worker_mode=traffic["worker_mode"], seed=loader_seed(seed), device=device,
            noise=Noise.seeded(seed, "trainer", device=device))

    def first_steps(self, steps: int) -> dict:
        """Run ``steps`` steps; returns the losses, the first gradient's
        norms by leaf, and the change of the parameters and of the EMA (of
        the first rate) by leaf, on the host."""
        from ivid_tpu_torch.training.trainer import StepRecord

        tr = self.trainer
        tr.record = StepRecord()
        grad0 = None
        for k in range(steps):
            tr.run_step()
            tr.step += 1
            if k == 0:
                # A parameter AdamW holds no moment for got no gradient.
                grad0 = {name: tr.optimizer.state[p].get("exp_avg", torch.zeros_like(p))
                         / (1 - BETA1) for name, p in tr.params.items()}
                grad0 = ref_train.leaf_norms(grad0)
        ema = tr.ema_params[0]
        change = {name: (p.detach() - self.start[name]).cpu() for name, p in tr.params.items()}
        ema_change = {name: (ema[name] - self.start[name]).cpu() for name in tr.params}
        losses = [float(x) for x in tr.record.losses]
        tr.record = None
        self.start = None
        return {"losses": losses, "grad0": grad0, "change": change, "ema_change": ema_change}

    def close(self) -> None:
        self.trainer.close()


def reference_steps(cfg: dict, traffic: dict, seed: int, device, precision: str = "f32",
                    fault=None) -> dict:
    """The reference's first ``check_steps`` steps, as :meth:`Program.
    first_steps` reports them, with ``mask``: the elements whose reference
    gradient moves them (:func:`port_bench.reference.train.moving_mask`).
    ``fault``, when given, is a planted fault (:mod:`port_bench.faults`):
    its ``framework`` maps the reference framework, its ``ema`` replaces
    the EMA's update."""
    fault = fault or {}
    section = _model(cfg)
    with torch.device(device):
        unet = build_unet(section["backbone"]["args"], precision)
    weights.load(unet, weights.draw(section["backbone"]["args"], seed, "cond", device))
    fw = ref_diffusion.Framework(section["framework"]["name"], unet,
                                 section["framework"]["args"], device)
    if "framework" in fault:
        fw = fault["framework"](fw)
    data = dataset(cfg, traffic)
    rows = first_batches(data, traffic["batch"], seed, traffic["check_steps"])
    batches = [torch.from_numpy(np.stack([data[int(i)]["x_0"] for i in r])).to(device)
               for r in rows]
    d = section["dataset"]["args"]
    t = section["trainer"]["args"]
    with devices.exact_f32():
        out = ref_train.steps(fw, dict(unet.named_parameters()), batches,
                              Noise.seeded(seed, "trainer", device=device),
                              augments=tuple(d.get("augments", ())),
                              pose_std=traffic["pose_std"], near=d["near"], far=d["far"],
                              lr=t["learning_rate"], weight_decay=t.get("weight_decay", 0.0),
                              ema_rate=ema_rate(cfg),
                              ema=fault.get("ema", ref_train.ema_update))
    host = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
    return {"losses": out["losses"], "grad0": ref_train.leaf_norms(out["grad0"]),
            "mask": host(ref_train.moving_mask(out["grad0"])),
            "change": host(out["change"]), "ema_change": host(out["ema_change"])}


def ema_rate(cfg: dict) -> float:
    """The first EMA rate of the trainer's configuration."""
    rate = _model(cfg)["trainer"]["args"]["ema_rate"]
    return float(rate[0] if isinstance(rate, (list, tuple)) else rate)


def gaps(got: dict, ref: dict) -> dict:
    """Each side's norms by leaf of what ``correct`` compares: the first
    gradient (every leaf), and the change of the parameters and of the EMA
    over the elements that the reference's gradient moves."""
    mask = ref["mask"]
    return {"grad0": (got["grad0"], ref["grad0"]),
            "change": (ref_train.masked_norms(got["change"], mask),
                       ref_train.masked_norms(ref["change"], mask)),
            "ema_change": (ref_train.masked_norms(got["ema_change"], mask),
                           ref_train.masked_norms(ref["ema_change"], mask))}


def readings(got: dict, ref: dict) -> dict:
    """The worst leaf's gap of the norms of the first gradient
    (``grad_gap``), of the parameters' change (``change_gap``) and of the
    EMA's change (``ema_gap``), the changes over the elements that the
    reference's gradient moves (see ``PERF.md`` for the rule and why the
    loss is not compared)."""
    g = gaps(got, ref)
    return {"grad_gap": ref_train.worst_leaf_gap(*g["grad0"]),
            "change_gap": ref_train.worst_leaf_gap(*g["change"]),
            "ema_gap": ref_train.worst_leaf_gap(*g["ema_change"])}


def run(r) -> dict:
    cfg, traffic, dev = r.config, r.traffic, r.device
    out_dir = tempfile.mkdtemp(prefix="port_bench_train_")
    try:
        return _run(r, cfg, traffic, dev, out_dir)
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
    return {"metrics": metrics, "facts": facts, "readings": readings(got, ref),
            "attempted": steps, "failed": failed}
