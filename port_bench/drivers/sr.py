"""Driver of the ``sr`` traffic kind: scenes of low-resolution RGBD views
upsampled through ``ivid_tpu_torch.sr.upsample_views``, the function the SR
CLI calls for each scene.

Before it builds anything the driver looks for ``upsample_views`` in the
program and exits non-zero without it. Set-up builds the configuration's
``sr`` model through the program's own config classes with the seeded
weights, and warms up the window's forward (a guided step of every chunk
size: the CUDA graph's warm-up and capture) with one scene of one step. The
window runs whole scenes (:func:`port_bench.window.run_whole_batches`), one
at a time: each scene's views are made on the host from the seed, moved to
the card, upsampled, and moved back to the host, as the CLI does before it
writes them; CUDA events around each ``upsample_views`` call give the
device time of its guided steps. ``correct`` follows the checked scenes'
views with the plain reference (:mod:`port_bench.reference.sr`) from the
same weights, condition, class and noise.

A scene is ``views`` procedural 128² RGBD items (:class:`port_bench.inputs.
SyntheticRGBD` blobs at the configuration's ``image_size_lr``, items drawn
from the seed and the scene's index), their colours in [0, 1] and their
depth as the disparity that ``project_depth`` gives between ``near`` and
``far``: what ``load_scene`` and ``project_depth`` hand the CLI. One class
per scene, uniform over the model's classes; the scene's noise source from
the seed and the scene's index, the chunk at view ``i`` its ``fold_in(i)``.

Traffic parameters: ``views``, ``blobs``, ``near``, ``far``, ``steps``,
``guidance``, ``batchsize`` (views per chunk, as the CLI's flag),
``ref_block`` (views per block of the reference), ``trace_batches`` (scenes
the traced run profiles after its window), ``check_batches`` (scenes
``correct`` compares) and ``check_views`` (the first views of a checked
scene that the reference follows: one ring of a ``3x9`` scene, since the
reference in f32 takes ~11 s a view at full width).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import device as devices
from port_bench import inputs, trace, weights
from port_bench.drivers import sample
from port_bench.noise import Noise
from port_bench.reference import sr as ref_sr
from port_bench.reference.unet import build_unet
from port_bench.window import run_whole_batches

ROLE = "sr"


def _section(cfg: dict) -> dict:
    return cfg["models"][ROLE]


def program_entry():
    """The program's ``ivid_tpu_torch.sr.upsample_views``; exits non-zero
    when the program has none."""
    from ivid_tpu_torch import sr

    entry = getattr(sr, "upsample_views", None)
    if entry is None:
        raise SystemExit("the program has no ivid_tpu_torch.sr.upsample_views: "
                         "it cannot run the sr kind")
    return entry


def scene_inputs(seed: int, i: int, traffic: dict, cfg: dict, device):
    """Scene ``i``'s (-1: the warm-up scene) views [V, s, s, 4] on the host
    in [0, 1], its class (None for a model without classes) and its noise
    source."""
    size = _section(cfg)["dataset"]["args"]["image_size_lr"]
    rng = inputs.host_rng(seed, 3, i + 1)
    maker = inputs.SyntheticRGBD(0, size, traffic["blobs"], traffic["near"], traffic["far"],
                                 (), 0.0)
    items = [maker._make(int(k)) for k in rng.integers(0, 2 ** 31, traffic["views"])]
    views = (np.stack(items) * 0.5 + 0.5).astype(np.float32)
    labels = inputs.classes(rng, 1, _section(cfg)["backbone"]["args"].get("num_classes"))
    cls = None if labels is None else int(labels[0])
    return views, cls, Noise.seeded(seed, "scene", i, device=device)


def chunks(traffic: dict) -> list:
    """The views of each chunk of a scene."""
    v, b = traffic["views"], traffic["batchsize"]
    return [min(b, v - i) for i in range(0, v, b)]


def forwards(cfg: dict, traffic: dict, scenes: int) -> list:
    """Forward passes of the UNet over ``scenes`` scenes: one a step of every
    chunk, at twice the chunk's views under classifier-free guidance."""
    args = _section(cfg)["backbone"]["args"]
    cfg_rows = 2 if args.get("num_classes") and traffic["guidance"] > 0 else 1
    out = {}
    for n in chunks(traffic):
        out[n] = out.get(n, 0) + traffic["steps"] * scenes
    return [{"backbone": args, "role": ROLE, "batch": cfg_rows * n, "count": c}
            for n, c in out.items()]


class Program:
    """The program's SR framework for one cell, its weights from a seed."""

    def __init__(self, cfg: dict, seed: int, device):
        from ivid_tpu_torch.config import build_backbone, build_framework_from_config

        self.upsample = program_entry()
        self.device = device
        c = sample._cfg_obj(_section(cfg))
        with torch.device(device):
            self.model = build_backbone(c)
        self.model.eval()
        self.fw = build_framework_from_config(c, self.model, device=device)
        self.image_size = _section(cfg)["backbone"]["args"]["image_size"]
        self.load(cfg, seed)

    def load(self, cfg: dict, seed: int) -> None:
        weights.load(self.model, weights.draw(_section(cfg)["backbone"]["args"], seed, ROLE,
                                              self.device))

    def scene(self, traffic: dict, views, cls, noise, steps=None, marks=None):
        """One scene's upsampled views on the host; ``marks``, when given,
        gets CUDA events recorded before and after the sampler's call."""
        x = torch.from_numpy(views).to(self.device)
        timing = marks is not None and self.device.type == "cuda"
        if timing:
            marks.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            marks[-1][0].record()
        out = self.upsample(self.fw, x, classes=cls, noise=noise.fold_in,
                            steps=steps or traffic["steps"], guidance=traffic["guidance"],
                            batchsize=traffic["batchsize"], image_size=self.image_size)
        if timing:
            marks[-1][1].record()
        return out.cpu()


class Reference:
    """The reference SR framework of the cell at ``precision``."""

    def __init__(self, cfg: dict, device, precision: str = "f32"):
        section = _section(cfg)
        self.device = device
        with torch.device(device):
            unet = build_unet(section["backbone"]["args"], precision)
        unet.eval().requires_grad_(False)
        self.fw = ref_sr.SuperResFramework(unet, section["framework"]["args"], device)

    def load(self, cfg: dict, seed: int) -> None:
        weights.load(self.fw.model, weights.draw(_section(cfg)["backbone"]["args"], seed, ROLE,
                                                 self.device))

    def scene(self, cfg: dict, traffic: dict, seed: int, i: int):
        """Scene ``i``'s first ``check_views`` upsampled views on the host."""
        views, cls, noise = scene_inputs(seed, i, traffic, cfg, self.device)
        out = ref_sr.upsample_views(
            self.fw, torch.from_numpy(views).to(self.device), classes=cls, noise=noise.fold_in,
            steps=traffic["steps"], guidance=traffic["guidance"],
            batchsize=traffic["batchsize"],
            image_size=_section(cfg)["backbone"]["args"]["image_size"],
            block=traffic["ref_block"], first=traffic["check_views"])
        return out.cpu()


def readings(got, want) -> dict:
    """``sr_rel``: the worst view's relative L2 distance between the judged
    side's upsampled views ``got`` and the reference's ``want`` (the first
    views of the scene, as many as the reference computed)."""
    got = got[:len(want)]
    diff = (got.double() - want.double()).flatten(1).norm(dim=1)
    return {"sr_rel": float((diff / want.double().flatten(1).norm(dim=1)).max())}


def peak_reserved_bytes(device) -> int:
    """The caching allocator's peak of reserved memory since the last reset:
    every block it holds, the CUDA graphs' private pools among them."""
    return int(torch.cuda.max_memory_reserved(device)) if device.type == "cuda" else 0


def control_precision(cfg: dict) -> str:
    """One step below the model's stated precision: bfloat16 for a float32
    model, float8 for a bfloat16 one."""
    return "fp8" if _section(cfg)["backbone"]["args"].get("use_fp16") else "bf16"


def run(r) -> dict:
    """One run of the cell: set-up, the window, then ``correct``. A traced
    run profiles ``trace_batches`` more scenes in one session once the
    window has closed."""
    cfg, traffic, dev = r.config, r.traffic, r.device
    prog = Program(cfg, r.seed, dev)
    prog.scene(traffic, *scene_inputs(r.seed, -1, traffic, cfg, dev), steps=1)
    r.setup_done()

    outputs, marks = [], []

    def one(i: int) -> None:
        outputs.append(prog.scene(traffic, *scene_inputs(r.seed, i, traffic, cfg, dev),
                                  marks=marks))

    devices.reset_peak(dev)
    times = run_whole_batches(one, r.seconds)
    peak_window = devices.peak_bytes(dev)
    reserved_window = peak_reserved_bytes(dev)
    n = len(times)
    box, n_traced = [], traffic["trace_batches"] if r.trace else 0
    if n_traced:
        with trace.session(box):
            for i in range(n, n + n_traced):
                one(i)
    failed = sum(int(not bool(torch.isfinite(o).all())) for o in outputs[:n])
    n_chunks = len(chunks(traffic))
    facts = {
        # Over the window, by CUDA events and the host clock.
        "window_s": sum(times), "scenes": n, "views": n * traffic["views"],
        "sr_ms": [a.elapsed_time(b) for a, b in marks[:n]],
        "guided_steps": n * n_chunks * traffic["steps"],
        "forwards": forwards(cfg, traffic, n), "peak_mem_window": peak_window,
        "reserved_mem_window": reserved_window,
        # Over the profiled scenes.
        "trace": trace.read(box[0]) if box else None,
        "traced": {"forwards": forwards(cfg, traffic, n_traced), "scenes": n_traced},
    }
    rate = n * traffic["views"] / sum(times)
    metrics = {"views_per_s": rate, "batch_views_per_s": rate}

    r.memory_peak()
    del prog
    devices.release(dev)
    pick = inputs.host_rng(r.seed, 2).choice(n, size=min(traffic["check_batches"], n),
                                             replace=False)
    ref = Reference(cfg, dev)
    ref.load(cfg, r.seed)
    got = [readings(outputs[int(i)], ref.scene(cfg, traffic, r.seed, int(i))) for i in pick]
    return {"metrics": metrics, "facts": facts,
            "readings": {k: max(g[k] for g in got) for k in got[0]},
            "attempted": n, "failed": failed}
