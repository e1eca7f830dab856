"""CPU tests of the benchmark harness: ``python -m pytest port_bench/tests``.

They run everything that needs no card: the manifest's rules, the window's
arithmetic, the FLOP and bound tables, the imports, and whole runs of each
driver at a tiny size on the CPU (the program's plain versions), intact,
with faults planted in the program, and with the control in its place."""

from __future__ import annotations

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    """The configuration ``name`` cut to a UNet of 16x16 images, two levels
    and one residual block a level (every width a tiny one)."""
    cfg = copy.deepcopy(load("port_bench", "configs", name + ".json"))
    for model in cfg["models"].values():
        a = model["backbone"]["args"]
        a.update(image_size=16, model_channels=32, channel_mult=[1, 2],
                 attention_resolutions=[8], num_res_blocks=1)
        if a.get("num_classes"):
            a["num_classes"] = 10
        model["dataset"]["args"]["image_size"] = 16
    return cfg


def tiny_traffic(name: str, **over) -> dict:
    t = copy.deepcopy(load("port_bench", "traffic", name + ".json"))
    if t["kind"] == "sample":
        t.update(steps_uncond=3, steps_cond=3, check_batches=1)
        t["batch"] = min(t["batch"], 2)
    else:
        t.update(batch=2, dataset=dict(length=8, blobs=3), num_workers=1)
    t.update(over)
    return t


class CpuRun:
    """A run on the CPU: what :class:`port_bench.run.Run` gives a driver,
    without the look for a card."""

    def __init__(self, workload: str, seed: int = 2 ** 31 + 7, seconds: float = 0.2,
                 trace: bool = False):
        import torch

        manifest = load("BENCHMARK.json")
        self.cell = next(w for w in manifest["workloads"] if w["name"] == workload)
        self.config = tiny_config(self.cell["config"])
        self.traffic = tiny_traffic(self.cell["traffic"])
        self.limits = load("port_bench", "limits", workload + ".json")
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device("cpu")
        self.setup_s = None
        self.memory_peak_bytes = 0

    def setup_done(self):
        self.setup_s = 0.0

    def memory_peak(self):
        pass


@pytest.fixture
def cpu_run():
    return CpuRun
