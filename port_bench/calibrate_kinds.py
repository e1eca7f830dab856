"""The readings that the limits of the ``sr`` and ``train_basic`` cells are
set from, in one process (``calibrate.py`` reads the ``sample`` and
``train`` kinds).

    python3 port_bench/calibrate_kinds.py --workload <name> --seeds 101-106 \
        [--control-seeds 201-203] [--fault-seeds 301-303] [--out readings.jsonl]

An ``sr`` cell: for each seed of ``--seeds``, the program's first scene
through ``upsample_views`` at the cell's own size against the reference, as
a run's ``correct`` reads it; of ``--fault-seeds``, the program with each
fault of :mod:`port_bench.sr_faults` planted; of ``--control-seeds``, the
reference one precision step below the configuration in the program's
place. The reference runs once a seed, whatever reads it. A ``train_basic``
cell: the program's first steps through ``run_step``, the control, and the
planted faults of :func:`port_bench.faults.train_faults` that apply to a
batch without a warped condition, each against the reference. One JSON
line a reading. The benchmark's runs never run this; it needs a card.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path = [ROOT] + [p for p in sys.path
                     if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]

import argparse  # noqa: E402
import json  # noqa: E402
import tempfile  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from port_bench import run as runmod
    from port_bench.calibrate import seeds

    manifest = runmod.load_json("BENCHMARK.json")
    files = runmod.cell_files(manifest, args.workload)
    cfg, traffic = runmod.load_json(files["config"]), runmod.load_json(files["traffic"])
    dev = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        rec = dict(rec, workload=args.workload, card=torch.cuda.get_device_name(dev))
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            print(line, file=sink, flush=True)

    kinds = {"sr": _sr, "train_basic": _train_basic}
    if traffic["kind"] not in kinds:
        raise SystemExit(f"calibrate_kinds.py reads the kinds {sorted(kinds)}; "
                         f"{args.workload} is {traffic['kind']!r} (calibrate.py)")
    try:
        kinds[traffic["kind"]](cfg, traffic, dev, seeds(args.seeds), seeds(args.control_seeds),
                               seeds(args.fault_seeds), emit)
    finally:
        if sink:
            sink.close()
    return 0


def _sr(cfg, traffic, dev, prog_seeds, ctl_seeds, fault_seeds, emit):
    import torch

    from port_bench import faults, sr_faults
    from port_bench.drivers import sr as drv

    def views_stats(x):
        return {"views_absmean": float(x.abs().mean()), "views_std": float(x.std())}

    prog = None
    if prog_seeds or fault_seeds:
        prog = drv.Program(cfg, (prog_seeds or fault_seeds)[0], dev)
        prog.scene(traffic, *drv.scene_inputs(0, -1, traffic, cfg, dev), steps=1)
    ref = drv.Reference(cfg, dev)
    ctl = drv.Reference(cfg, dev, drv.control_precision(cfg)) if ctl_seeds else None
    for seed in sorted(set(prog_seeds) | set(ctl_seeds) | set(fault_seeds)):
        ref.load(cfg, seed)
        t0 = time.perf_counter()
        want = ref.scene(cfg, traffic, seed, 0)
        ref_s = time.perf_counter() - t0
        if seed in prog_seeds or seed in fault_seeds:
            prog.load(cfg, seed)
        if seed in prog_seeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = prog.scene(traffic, *drv.scene_inputs(seed, 0, traffic, cfg, dev))
            emit(dict(drv.readings(got, want), side="program", seed=seed,
                      scene_s=time.perf_counter() - t0, reference_s=ref_s, **views_stats(got)))
        for name, plant in sr_faults.SR_PROGRAM_FAULTS.items() if seed in fault_seeds else ():
            patches = faults.Patches()
            plant(patches)
            try:
                got = prog.scene(traffic, *drv.scene_inputs(seed, 0, traffic, cfg, dev))
            finally:
                patches.undo()
            emit(dict(drv.readings(got, want), side="fault", fault=name, seed=seed,
                      **views_stats(got)))
        if seed in ctl_seeds:
            ctl.load(cfg, seed)
            got = ctl.scene(cfg, traffic, seed, 0)
            emit(dict(drv.readings(got, want), side="control", seed=seed,
                      precision=drv.control_precision(cfg), **views_stats(got)))


def _train_basic(cfg, traffic, dev, prog_seeds, ctl_seeds, fault_seeds, emit):
    import torch

    from port_bench import faults
    from port_bench.calibrate import _train_detail
    from port_bench.drivers import train
    from port_bench.drivers import train_basic as drv

    precision = "fp8" if drv._model(cfg)["backbone"]["args"].get("use_fp16") else "bf16"
    for seed in prog_seeds:
        with tempfile.TemporaryDirectory() as out_dir:
            prog = drv.Program(cfg, traffic, seed, dev, out_dir)
            try:
                got = prog.first_steps(traffic["check_steps"])
            finally:
                prog.close()
        del prog
        torch.cuda.empty_cache()
        ref = drv.reference_steps(cfg, traffic, seed, dev)
        emit(dict(train.readings(got, ref), side="program", seed=seed,
                  **_train_detail(got, ref)))
    for seed in sorted(set(ctl_seeds) | set(fault_seeds)):
        ref = drv.reference_steps(cfg, traffic, seed, dev)
        # ``row_altered`` blanks a warped condition, which this batch has not.
        planted = {k: v for k, v in faults.train_faults().items() if k != "row_altered"}
        if seed in ctl_seeds:
            ctl = drv.reference_steps(cfg, traffic, seed, dev, precision=precision)
            emit(dict(train.readings(ctl, ref), side="control", seed=seed, precision=precision,
                      **_train_detail(ctl, ref)))
        for name, fault in planted.items() if seed in fault_seeds else ():
            got = drv.reference_steps(cfg, traffic, seed, dev, fault=fault)
            emit(dict(train.readings(got, ref), side="fault", fault=name, seed=seed,
                      **_train_detail(got, ref)))


if __name__ == "__main__":
    sys.exit(main())
