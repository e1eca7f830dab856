"""The two cells added with the SR configuration: ``in256sr.sr.scene27_b27``
(the ``sr`` driver) and ``in128.train.uncond_b16`` (``train_basic``): their
files found by name, the yardstick's tables for the SR model, whole CPU runs
at a tiny size with faults planted in the program, and what they load."""

from __future__ import annotations

import ast
import os

import pytest
import torch
from conftest import ROOT, CpuRun, load
from test_bench_imports import FORBIDDEN, _run

from port_bench import attention_bound, faults, flops, run, sr_faults, weights

SR_CELL = "in256sr.sr.scene27_b27"
TRAIN_CELL = "in128.train.uncond_b16"


@pytest.mark.parametrize("workload,kind", [(SR_CELL, "sr"), (TRAIN_CELL, "train_basic")])
def test_new_cells_find_their_files(workload, kind):
    manifest = load("BENCHMARK.json")
    files = run.cell_files(manifest, workload)
    for key in ("config", "traffic", "limits"):
        assert os.path.isfile(files[key]), files[key]
    assert load(files["traffic"])["kind"] == kind
    assert os.path.isfile(os.path.join(ROOT, "port_bench", "drivers", kind + ".py"))


def sr_args():
    return load("port_bench", "configs", "in256sr.json")["models"]["sr"]["backbone"]["args"]


def test_sr_forward_flops_and_parameters():
    """697.8 GFLOP an image forward at 256² and 105.7M parameters."""
    args = sr_args()
    assert round(flops.forward_flops(args, 1) / 1e9, 1) == 697.8
    assert flops.forward_flops(args, 54) == 54 * flops.forward_flops(args, 1)
    n = sum(int(torch.Size(s).numel()) for _, s, _ in weights.layout(args))
    assert round(n / 1e6, 1) == 105.7


def test_sr_kernel_sites():
    """Five sites at 64² (T=4096, 4 heads) and five at 32² (T=1024, 6
    heads) go through K1; the 16² sites take the plain form."""
    assert attention_bound.kernel_sites(sr_args()) == [(4096, 4)] * 5 + [(1024, 6)] * 5


def sr_run(seed=2 ** 31 + 7, trace=False):
    """A CPU run of the SR cell at 32² from 16²: two levels, attention at
    16², 3 views in chunks of 2, 2 guided steps."""
    r = CpuRun(SR_CELL, seed=seed, trace=trace)
    model = r.config["models"]["sr"]
    model["backbone"]["args"].update(image_size=32, attention_resolutions=[16])
    model["dataset"]["args"].update(image_size=32, image_size_lr=16)
    r.traffic.update(views=3, steps=2, batchsize=2, ref_block=2, trace_batches=1)
    return r


def correct(r, out) -> bool:
    return run.judge(out["readings"], r.limits)[0] and out["failed"] == 0


@pytest.fixture(scope="module")
def sr_intact():
    from port_bench.drivers import sr

    r = sr_run(trace=True)
    return r, sr.run(r)


def test_sr_run_reports_its_facts(sr_intact):
    """The window's scenes, their views and guided steps, and the readers
    that find something on the CPU (a trace without device activity)."""
    r, out = sr_intact
    f = out["facts"]
    n = out["attempted"]
    assert n >= 1 and out["failed"] == 0 and f["views"] == 3 * n
    assert f["guided_steps"] == 2 * 2 * n
    assert [(x["batch"], x["count"]) for x in f["forwards"]] == [(4, 2 * n), (2, 2 * n)]
    assert out["metrics"]["views_per_s"] == out["metrics"]["batch_views_per_s"] > 0
    assert set(out["readings"]) == set(r.limits) == {"sr_rel"}
    manifest = load("BENCHMARK.json")
    read = {m["name"]: run.read_layer_metric(m, dict(f, device_kind="cpu"), r)
            for m in run.layer_metrics(manifest, SR_CELL)}
    assert read["sr.idle_ms_per_scene.sr"] is not None
    assert read["sr.host_syncs_per_scene.sr"] is not None
    assert read["sr.step_ms.sr"] is None and read["sr.reserved_mem_gib.sr"] is None


@pytest.mark.parametrize("fault", sorted(sr_faults.SR_PROGRAM_FAULTS))
def test_sr_fault_is_not_correct(fault, monkeypatch, sr_intact):
    """Each planted fault fails the cell's limit, and by a reading well above
    the intact run's (the fault, not the tiny size, is what fails)."""
    from port_bench.drivers import sr

    sr_faults.SR_PROGRAM_FAULTS[fault](monkeypatch.setattr)
    r = sr_run()
    out = sr.run(r)
    intact = sr_intact[1]["readings"]["sr_rel"]
    assert not correct(r, out), out["readings"]
    assert out["readings"]["sr_rel"] > max(r.limits["sr_rel"], 3 * intact), (out, intact)


def test_sr_control_reads_above_the_program(sr_intact):
    """The reference in float8 in the program's place reads well above the
    program (at this size and on the CPU, the program's own bf16 gap is
    several times the card's at full width; the limit is the card's)."""
    from port_bench.drivers import sr

    r = sr_run()
    cfg, traffic = r.config, r.traffic
    ref, ctl = sr.Reference(cfg, r.device), sr.Reference(cfg, r.device, sr.control_precision(cfg))
    ref.load(cfg, r.seed)
    ctl.load(cfg, r.seed)
    reading = sr.readings(ctl.scene(cfg, traffic, r.seed, 0), ref.scene(cfg, traffic, r.seed, 0))
    assert reading["sr_rel"] > 3 * sr_intact[1]["readings"]["sr_rel"]


def test_sr_driver_exits_without_the_entry(monkeypatch):
    """A program without ``sr.upsample_views`` (the one before it) makes the
    run exit non-zero before it builds a model."""
    from ivid_tpu_torch import sr as program_sr
    from port_bench.drivers import sr

    monkeypatch.delattr(program_sr, "upsample_views")
    monkeypatch.setattr(sr.Program, "load", lambda *a: pytest.fail("a model was built"))
    with pytest.raises(SystemExit) as exc:
        sr.run(sr_run())
    assert exc.value.code not in (0, None)


def test_train_basic_intact_and_faults():
    """The basic trainer's cell on the CPU: intact it is correct; the EMA
    never updated and the loss over half the batch are not (planted in the
    reference where it stands in the program's place)."""
    from port_bench.drivers import train, train_basic

    r = CpuRun(TRAIN_CELL)
    out = train_basic.run(r)
    assert correct(r, out), out["readings"]
    ref = train_basic.reference_steps(r.config, r.traffic, r.seed, r.device)
    for name in ("ema_skipped", "half_batch"):
        got = train_basic.reference_steps(r.config, r.traffic, r.seed, r.device,
                                          fault=faults.train_faults()[name])
        readings = train.readings(got, ref)
        assert not run.judge(readings, r.limits)[0], (name, readings)


def test_new_drivers_load_no_jax():
    """Running the ``sr`` and ``train_basic`` drivers on the CPU at a tiny
    size loads no module of JAX or of the JAX package."""
    top = _run("""
        import sys
        sys.path.insert(0, "port_bench/tests")
        from conftest import CpuRun
        from port_bench.drivers import sr, train_basic
        r = CpuRun("in256sr.sr.scene27_b27")
        r.config["models"]["sr"]["dataset"]["args"]["image_size_lr"] = 8
        r.traffic.update(views=2, steps=1, batchsize=2, ref_block=1)
        sr.run(r)
        train_basic.run(CpuRun("in128.train.uncond_b16"))
        print(sorted({m.split(".")[0] for m in sys.modules}))
    """)
    loaded = set(ast.literal_eval(top))
    assert "ivid_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
