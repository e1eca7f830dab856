"""Driver of the ``sample`` traffic kind: batches of multiview scenes through
``ScenePipeline.sample_batch``.

Set-up builds the configuration's uncond and cond models through the
program's own config classes, loads the seeded weights, and warms up every
shape the window uses with one batch of one uncond and one guided step.
The window runs whole batches (:func:`port_bench.window.run_whole_batches`)
and moves each batch's views and conditions to the host, as a user's run
would. ``correct`` follows the checked batches stage by stage against the
reference (:func:`port_bench.reference.pipeline.check_batch`).

Traffic parameters: ``views`` (:func:`port_bench.inputs.views`), ``batch``,
``steps_uncond``, ``steps_cond``, ``guidance``, ``ssaa``, ``fov``, ``near``,
``far``, ``atol``, ``rtol``, ``erode_rgb``, ``trace_batches``
(how many batches the traced run profiles after its window) and
``check_batches`` (how many finished batches ``correct`` compares).
"""

from __future__ import annotations

import torch

from port_bench import device as devices
from port_bench import inputs, trace, weights
from port_bench.noise import Noise
from port_bench.reference import diffusion as ref_diffusion
from port_bench.reference import pipeline as ref_pipeline
from port_bench.reference.unet import build_unet
from port_bench.window import run_whole_batches

ROLES = ("uncond", "cond")


def _section(cfg: dict, role: str) -> dict:
    return cfg["models"][role]


def _cfg_obj(section: dict):
    from ivid_tpu_torch.config import Config

    return Config(**{k: section[k] for k in ("backbone", "framework", "dataset", "trainer")
                     if k in section})


def pipeline_params(traffic: dict, image_size: int) -> dict:
    keys = ("steps_uncond", "steps_cond", "guidance", "ssaa", "fov", "near", "far", "atol",
            "rtol", "erode_rgb")
    p = {k: traffic[k] for k in keys}
    p["image_size"] = image_size
    return p


def batch_inputs(seed: int, i: int, traffic: dict, num_classes, device):
    """The noise source, cameras [B, V, 4, 4] and class labels of batch
    ``i`` (-1: the warm-up batch)."""
    rng = inputs.host_rng(seed, 1, i + 1)
    views = inputs.views(rng, traffic["batch"], traffic["views"])
    labels = inputs.classes(rng, traffic["batch"], num_classes)
    labels = None if labels is None else torch.from_numpy(labels).to(device)
    return Noise.seeded(seed, "batch", i, device=device), views, labels


def forward_batch(section: dict, batch: int, guidance: float) -> int:
    """Rows of one forward of a model: twice the batch under
    classifier-free guidance (one batched forward over [cond; null])."""
    cfg_kinds = ("ClassifierFreeGuidance", "InpaintCFG")
    cfg = (section["framework"]["name"] in cfg_kinds and guidance > 0
           and bool(section["backbone"]["args"].get("num_classes")))
    return 2 * batch if cfg else batch


def forwards(cfg: dict, traffic: dict, batches: int, n_views: int) -> list:
    """Forward passes of each model over ``batches`` batches."""
    b = traffic["batch"]
    out = []
    for role, count in (("uncond", traffic["steps_uncond"]),
                        ("cond", traffic["steps_cond"] * (n_views - 1))):
        sec = _section(cfg, role)
        out.append({"backbone": sec["backbone"]["args"], "role": role,
                    "batch": forward_batch(sec, b, traffic["guidance"]),
                    "count": count * batches})
    return out


class Program:
    """The program's objects for one cell: frameworks and the window's
    pipeline."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from ivid_tpu_torch.config import build_backbone, build_framework_from_config
        from ivid_tpu_torch.inference.pipeline import ScenePipeline

        self.device = device
        self.models, fws = {}, {}
        for role in ROLES:
            section = _section(cfg, role)
            c = _cfg_obj(section)
            with torch.device(device):
                model = build_backbone(c)
            model.eval()
            self.models[role] = model
            fws[role] = build_framework_from_config(c, model, device=device)
        self.load(cfg, seed)
        self.image_size = _section(cfg, "uncond")["backbone"]["args"]["image_size"]
        p = pipeline_params(traffic, self.image_size)
        kw = dict(image_size=self.image_size, fov=p["fov"], near=p["near"], far=p["far"],
                  atol=p["atol"], rtol=p["rtol"], erode_rgb=p["erode_rgb"],
                  guidance=p["guidance"], ssaa=p["ssaa"], device=device)
        self.warm = ScenePipeline(fws["uncond"], fws["cond"], steps_uncond=1, steps_cond=1, **kw)
        self.pipe = ScenePipeline(fws["uncond"], fws["cond"], steps_uncond=p["steps_uncond"],
                                  steps_cond=p["steps_cond"], **kw)

    def load(self, cfg: dict, seed: int) -> None:
        for role, model in self.models.items():
            weights.load(model, weights.draw(_section(cfg, role)["backbone"]["args"], seed,
                                             role, self.device))

    def batch(self, pipe, rng, views, labels, batch: int) -> dict:
        """One batch, its outputs on the host."""
        _, samples, conds = pipe.sample_batch(rng, views, batch=batch, classes=labels)
        return {"samples": samples.cpu(),
                "conds": {k: v.cpu() for k, v in conds.items()} if conds else None}


class Reference:
    """The reference frameworks of the cell at one ``precision`` per role."""

    def __init__(self, cfg: dict, device, precision=None):
        precision = precision or {r: "f32" for r in ROLES}
        self.device = device
        self.fws = {}
        for role in ROLES:
            section = _section(cfg, role)
            with torch.device(device):
                unet = build_unet(section["backbone"]["args"], precision[role])
            unet.eval().requires_grad_(False)
            self.fws[role] = ref_diffusion.Framework(section["framework"]["name"], unet,
                                                     section["framework"]["args"], device)

    def load(self, cfg: dict, seed: int) -> None:
        for role, fw in self.fws.items():
            weights.load(fw.model, weights.draw(_section(cfg, role)["backbone"]["args"], seed,
                                                role, self.device))


def judge(cfg: dict, traffic: dict, seed: int, ref: Reference, judged: dict, i: int) -> dict:
    """Readings of batch ``i``'s host outputs ``judged`` against ``ref``."""
    dev = ref.device
    num_classes = _section(cfg, "uncond")["backbone"]["args"].get("num_classes")
    rng, views, labels = batch_inputs(seed, i, traffic, num_classes, dev)
    p = pipeline_params(traffic, judged["samples"].shape[2])
    on_dev = {"samples": judged["samples"].to(dev), "conds": judged.get("conds")}
    with devices.exact_f32(), torch.no_grad():
        return ref_pipeline.check_batch(on_dev, ref.fws["uncond"], ref.fws["cond"], rng,
                                        torch.from_numpy(views).to(dev), labels, p)


def worst(readings: list) -> dict:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def control_precision(cfg: dict) -> dict:
    """One step below each model's stated precision: bfloat16 for a float32
    model, float8 for a bfloat16 one."""
    return {role: "fp8" if _section(cfg, role)["backbone"]["args"].get("use_fp16") else "bf16"
            for role in ROLES}


def bf16_views(x):
    return x.to(torch.bfloat16).float()


def control_outputs(cfg: dict, traffic: dict, seed: int, ctl: Reference, i: int) -> dict:
    """Batch ``i`` computed by the control: the reference one precision step
    below the configuration, its views rounded to bfloat16 before they are
    lifted and aggregated. Host outputs, as the program's."""
    dev = ctl.device
    num_classes = _section(cfg, "uncond")["backbone"]["args"].get("num_classes")
    rng, views, labels = batch_inputs(seed, i, traffic, num_classes, dev)
    p = pipeline_params(traffic, _section(cfg, "uncond")["backbone"]["args"]["image_size"])
    with devices.exact_f32(), torch.no_grad():
        out = ref_pipeline.run_batch(ctl.fws["uncond"], ctl.fws["cond"], rng,
                                     torch.from_numpy(views).to(dev), labels, traffic["batch"],
                                     p["image_size"], p, view_round=bf16_views)
    return {"samples": out.cpu()}


def run(r) -> dict:
    """One run of the cell: set-up, the window, then ``correct``. A traced
    run profiles ``trace_batches`` more batches in one session once the
    window has closed, so the profiler slows none of the window's."""
    cfg, traffic, dev = r.config, r.traffic, r.device
    num_classes = _section(cfg, "uncond")["backbone"]["args"].get("num_classes")
    b = traffic["batch"]
    prog = Program(cfg, traffic, r.seed, dev)
    prog.batch(prog.warm, *batch_inputs(r.seed, -1, traffic, num_classes, dev), b)
    r.setup_done()

    outputs = []

    def one(i: int) -> None:
        rng, views, labels = batch_inputs(r.seed, i, traffic, num_classes, dev)
        outputs.append(prog.batch(prog.pipe, rng, views, labels, b))

    devices.reset_peak(dev)
    before = prog.pipe.stage_ms()
    times = run_whole_batches(one, r.seconds)
    after = prog.pipe.stage_ms()
    peak_window = devices.peak_bytes(dev)
    n = len(times)
    n_views = outputs[0]["samples"].shape[1]
    box, n_traced = [], traffic["trace_batches"] if r.trace else 0
    if n_traced:
        with trace.session(box):
            for i in range(n, n + n_traced):
                one(i)
    failed = sum(int(not bool(torch.isfinite(o["samples"]).all())) for o in outputs[:n])
    facts = {
        # Over the window, by the pipeline's events and the host clock.
        "window_s": sum(times), "batches": n, "novel_views": n * b * (n_views - 1),
        "uncond_steps": n * traffic["steps_uncond"],
        "cond_steps": n * (n_views - 1) * traffic["steps_cond"],
        "stage_ms": {k: v - before.get(k, 0.0) for k, v in after.items()},
        "forwards": forwards(cfg, traffic, n, n_views), "peak_mem_window": peak_window,
        # Over the profiled batches.
        "trace": trace.read(box[0]) if box else None,
        "traced": {"forwards": forwards(cfg, traffic, n_traced, n_views),
                   "novel_views": n_traced * b * (n_views - 1), "batches": n_traced},
    }
    # The same rate under two names: a cell reports the one (or both) that
    # BENCHMARK.json lists for it, each with its own bound.
    rate = n * b * n_views / sum(times)
    metrics = {"views_per_s": rate, "batch_views_per_s": rate}

    r.memory_peak()
    del prog
    devices.release(dev)
    pick = inputs.host_rng(r.seed, 2).choice(n, size=min(traffic["check_batches"], n),
                                             replace=False)
    ref = Reference(cfg, dev)
    ref.load(cfg, r.seed)
    readings = worst([judge(cfg, traffic, r.seed, ref, outputs[int(i)], int(i)) for i in pick])
    return {"metrics": metrics, "facts": facts, "readings": readings,
            "attempted": n, "failed": failed}
