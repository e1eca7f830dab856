"""The harness's own pieces: the noise source, the weights, the trace
reader and the result line."""

from __future__ import annotations

import json
import statistics

import pytest
import torch
from conftest import CpuRun, load, tiny_config

from port_bench import noise, run, trace, weights


def test_noise_depends_on_derivation_only():
    a = noise.Noise.seeded(2 ** 31 + 3, "batch", 0)
    x1 = a.split()[1].fold_in(4).normal((3,))
    a.normal((100,))
    x2 = a.split()[1].fold_in(4).normal((3,))
    assert torch.equal(x1, x2)
    b = noise.Noise.seeded(2 ** 31 + 4, "batch", 0)
    assert not torch.equal(x1, b.split()[1].fold_in(4).normal((3,)))


def test_weights_load_into_the_program_model():
    """The reference's parameter names are the program's, the draw repeats
    for a seed, and no layer is left at zero."""
    from ivid_tpu_torch.config import Config, build_backbone

    cfg = tiny_config("in128")["models"]["uncond"]
    args = cfg["backbone"]["args"]
    model = build_backbone(Config(backbone=cfg["backbone"], framework=cfg["framework"]))
    w = weights.draw(args, 5, "uncond", torch.device("cpu"))
    weights.load(model, w)
    again = weights.draw(args, 5, "uncond", torch.device("cpu"))
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert all(bool(v.abs().sum() > 0) for k, v in w.items() if not k.endswith("shift"))
    out = model(torch.randn(2, 16, 16, 4), torch.tensor([3, 900]), torch.tensor([1, -1]))
    assert float(out.detach().abs().mean()) > 1e-3


def test_trace_reader_busy_and_gaps():
    tr = trace.Trace(
        device=[("k2_raster", 1.0, 2.0), ("gemm", 1.5, 3.0), ("k2_bin", 5.0, 6.0)],
        host=[("aten::conv", 3.0, 5.0), ("cudaLaunchKernel", 3.5, 4.5),
              (trace.WINDOW, 0.0, 8.0)],
        window=(0.0, 8.0))
    assert tr.busy_s == pytest.approx(3.0)
    assert tr.device_s(("k2_",)) == pytest.approx(2.0) and tr.count(("k2_",)) == 2
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    assert gaps["cudaLaunchKernel"] == pytest.approx(2.0)
    assert gaps["idle"] == pytest.approx(3.0)
    assert tr.top_device_ops()[0][0] in ("k2_raster", "gemm")


def test_trace_session_on_the_cpu_reads_a_window():
    box = []
    with trace.session(box):
        torch.randn(64, 64) @ torch.randn(64, 64)
    tr = trace.read(box[0])
    assert tr is not None and tr.window_s > 0 and tr.device == []


def test_result_line_shape():
    manifest = load("BENCHMARK.json")
    r = CpuRun("sc128.sample.random_b1", trace=False)
    r.setup_s = 12.5
    out = {"metrics": {"views_per_s": 0.5}, "facts": {}, "attempted": 3, "failed": 0,
           "readings": {k: 0.0 for k in r.limits}}
    res = run.assemble(manifest, "sc128.sample.random_b1", r, out, r.limits)
    assert list(res)[:3] == ["correct", "attempted", "failed"] and list(res)[-1] == "checks"
    assert res["correct"] is True
    assert set(res["metrics"]) == {"views_per_s", "setup_s"}
    json.dumps(res)
    bad = dict(out, readings={k: 10.0 for k in r.limits})
    assert run.assemble(manifest, "sc128.sample.random_b1", r, bad, r.limits)["correct"] is False
    nan = dict(out, readings={k: float("nan") for k in r.limits})
    assert run.assemble(manifest, "sc128.sample.random_b1", r, nan, r.limits)["correct"] is False


@pytest.mark.parametrize("workload,names", [
    ("in128.sample.random_b8", {"views_per_s", "batch_views_per_s", "setup_s"}),
    ("sc128.sample.random_b1", {"views_per_s", "setup_s"}),
    ("sc128.train.inpaint_b8", {"train_device_ms_per_image", "setup_s"})])
def test_each_cell_reports_its_listed_rates(workload, names):
    """A driver gives every rate it can; the result holds those that
    BENCHMARK.json lists for the cell."""
    manifest = load("BENCHMARK.json")
    r = CpuRun(workload)
    r.setup_s = 12.5
    out = {"metrics": {"views_per_s": 1.9, "batch_views_per_s": 1.9,
                       "train_device_ms_per_image": 8.2}, "facts": {},
           "attempted": 3, "failed": 0, "readings": {k: 0.0 for k in r.limits}}
    assert set(run.assemble(manifest, workload, r, out, r.limits)["metrics"]) == names


def test_traced_result_reads_the_layer_metrics():
    manifest = load("BENCHMARK.json")
    r = CpuRun("sc128.sample.random_b1", trace=True)
    facts = {"stage_ms": {"aggregation": 30.0, "uncond": 500.0, "cond": 600.0},
             "novel_views": 1, "uncond_steps": 10, "cond_steps": 10, "window_s": 2.0,
             "forwards": [], "peak_mem_window": 2 ** 30,
             "trace": trace.Trace([("gemm", 0.5, 1.5)], [(trace.WINDOW, 0.0, 2.0)], (0.0, 2.0)),
             "traced": {"forwards": [], "novel_views": 1}}
    out = {"metrics": {}, "facts": facts, "attempted": 1, "failed": 0,
           "readings": {k: 0.0 for k in r.limits}}
    res = run.assemble(manifest, "sc128.sample.random_b1", r, out, r.limits)
    m = res["metrics"]
    assert m["pipeline.aggregation_ms_per_view.sample"]["value"] == 30.0
    assert m["sampler.uncond_step_ms.sample"]["value"] == 50.0
    assert m["peak_mem_gib.sample"]["value"] == 1.0
    assert m["idle_share.sample"]["value"] == 50.0
    assert res["device"]["busy_s"] == 1.0 and res["device"]["window_s"] == 2.0
    assert "k1_roofline.sample" not in m and "k2.device_ms_per_view.sample" not in m
    assert list(res["breakdown"]) == ["device_ops", "idle_gaps"]
    empty = dict(out, facts=dict(facts, trace=None))
    with pytest.raises(RuntimeError):
        run.assemble(manifest, "sc128.sample.random_b1", r, empty, r.limits)


def test_traced_training_result_reads_the_step_tail():
    """The training cell's step-time tail and wall rate are per-layer
    readings of the traced run (its CUDA events and host clock over every
    step of the window)."""
    manifest = load("BENCHMARK.json")
    r = CpuRun("sc128.train.inpaint_b8", trace=True)
    steps = [100.0 + k for k in range(200)]
    facts = {"stage_ms": [], "loader_waits": [], "window_s": 30.0, "steps": 200,
             "images": 1600, "step_ms": steps, "forwards": [], "peak_mem_window": 2 ** 30,
             "trace": trace.Trace([("gemm", 0.5, 1.5)], [(trace.WINDOW, 0.0, 2.0)], (0.0, 2.0)),
             "traced": {"forwards": [], "steps": 10}}
    out = {"metrics": {}, "facts": facts, "attempted": 200, "failed": 0,
           "readings": {k: 0.0 for k in r.limits}}
    m = run.assemble(manifest, "sc128.train.inpaint_b8", r, out, r.limits)["metrics"]
    assert m["trainer.step_ms_p90.train"]["value"] == statistics.quantiles(steps, n=10)[-1]
    assert m["trainer.images_per_s.train"]["value"] == pytest.approx(1600 / 30.0)
    assert "train_device_ms_per_image" not in m
