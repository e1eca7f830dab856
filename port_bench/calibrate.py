"""The readings that a cell's limits are set from, in one process.

    python3 port_bench/calibrate.py --workload <name> --seeds 101-112 \
        [--control-seeds 201-203] [--fault-seeds 301-303] [--out chiprun_out/cal.jsonl]

For each seed of ``--seeds``: the program's timed path at the cell's own
size (one batch of a ``sample`` cell through the window's pipeline, the
first steps of a ``train`` cell through ``run_step``) against the
reference, as a run's ``correct`` reads it. For each seed of
``--control-seeds``: the control, the reference one precision step below the
configuration put in the program's place (see ``README.md``). For each
seed of ``--fault-seeds``: a ``train`` cell's
reference with each planted fault in the program's place, a ``sample``
cell's program with each fault planted in its aggregation
(:mod:`port_bench.faults`). One JSON line a reading. The benchmark's runs
never run this; it needs a card.
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


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


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

    if traffic["kind"] == "sample":
        _sample(cfg, traffic, dev, seeds(args.seeds), seeds(args.control_seeds),
                seeds(args.fault_seeds), emit)
    else:
        _train(cfg, traffic, dev, seeds(args.seeds), seeds(args.control_seeds),
               seeds(args.fault_seeds), emit)
    if sink:
        sink.close()
    return 0


def _sample(cfg, traffic, dev, prog_seeds, ctl_seeds, fault_seeds, emit):
    from port_bench import faults as planted
    from port_bench.drivers import sample as drv

    num_classes = cfg["models"]["uncond"]["backbone"]["args"].get("num_classes")
    b = traffic["batch"]
    ref = drv.Reference(cfg, dev)
    if prog_seeds or fault_seeds:
        first = (prog_seeds or fault_seeds)[0]
        prog = drv.Program(cfg, traffic, first, dev)
        prog.batch(prog.warm, *drv.batch_inputs(first, -1, traffic, num_classes, dev), b)
        for seed in prog_seeds:
            prog.load(cfg, seed)
            t0 = time.perf_counter()
            out = prog.batch(prog.pipe, *drv.batch_inputs(seed, 0, traffic, num_classes, dev), b)
            t1 = time.perf_counter()
            ref.load(cfg, seed)
            r = drv.judge(cfg, traffic, seed, ref, out, 0)
            emit(dict(r, side="program", seed=seed, batch_s=t1 - t0,
                      reference_s=time.perf_counter() - t1, **_sample_stats(out)))
        for seed in fault_seeds:
            prog.load(cfg, seed)
            ref.load(cfg, seed)
            for name, plant in planted.SAMPLE_PROGRAM_FAULTS.items():
                patches = planted.Patches()
                plant(patches)
                try:
                    out = prog.batch(prog.pipe, *drv.batch_inputs(seed, 0, traffic, num_classes,
                                                                  dev), b)
                finally:
                    patches.undo()
                emit(dict(drv.judge(cfg, traffic, seed, ref, out, 0), side="fault", fault=name,
                          seed=seed, **_sample_stats(out)))
        del prog
    if ctl_seeds:
        ctl = drv.Reference(cfg, dev, drv.control_precision(cfg))
        for seed in ctl_seeds:
            ctl.load(cfg, seed)
            ref.load(cfg, seed)
            out = drv.control_outputs(cfg, traffic, seed, ctl, 0)
            emit(dict(drv.judge(cfg, traffic, seed, ref, out, 0), side="control", seed=seed,
                      precision=drv.control_precision(cfg), **_sample_stats(out)))


def _sample_stats(out) -> dict:
    """What the views hold: their sizes, and (the program's) the share of
    condition pixels the aggregation covered."""
    x, c = out["samples"], out.get("conds")
    stats = {"views_absmax": float(x.abs().max()), "views_absmean": float(x.abs().mean())}
    if c is not None:
        stats["cond_covered"] = float((c["depth"] != -1).float().mean())
    return stats


def _train_detail(got, ref) -> dict:
    """What the compared numbers leave out: the median leaf's gaps, the
    worst leaf of each change and its name, the gap of the change over
    whole leaves (no element left out), the share of elements kept, and
    each step's relative loss gap."""
    from port_bench.drivers import train as drv
    from port_bench.reference import train as ref_train

    g = drv.gaps(got, ref)
    out = {}
    for key, (a, b) in g.items():
        out[key + "_median_leaf"] = ref_train.median_leaf_gap(a, b)
        out[key + "_worst_leaf_name"] = max(
            b, key=lambda k: ref_train.worst_leaf_gap(a, b, {k}))
    whole = {k: ref_train.leaf_norms(got[k]) for k in ("change", "ema_change")}
    whole_ref = {k: ref_train.leaf_norms(ref[k]) for k in ("change", "ema_change")}
    for k in whole:
        out[k + "_whole_leaves_worst"] = ref_train.worst_leaf_gap(whole[k], whole_ref[k])
    kept = sum(int(m.sum()) for m in ref["mask"].values())
    out["elements_kept"] = kept / sum(m.numel() for m in ref["mask"].values())
    out["loss_rel_by_step"] = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    return out


def _train(cfg, traffic, dev, prog_seeds, ctl_seeds, fault_seeds, emit):
    import torch

    from port_bench import faults as planted
    from port_bench.drivers import train as drv

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
        emit(dict(drv.readings(got, ref), side="program", seed=seed, **_train_detail(got, ref)))
    for seed in sorted(set(ctl_seeds) | set(fault_seeds)):
        ref = drv.reference_steps(cfg, traffic, seed, dev)
        if seed in ctl_seeds:
            ctl = drv.reference_steps(cfg, traffic, seed, dev, precision="fp8")
            emit(dict(drv.readings(ctl, ref), side="control", seed=seed, precision="fp8",
                      **_train_detail(ctl, ref)))
        for name, fault in planted.train_faults().items() if seed in fault_seeds else ():
            got = drv.reference_steps(cfg, traffic, seed, dev, fault=fault)
            emit(dict(drv.readings(got, ref), side="fault", fault=name, seed=seed,
                      **_train_detail(got, ref)))


if __name__ == "__main__":
    sys.exit(main())
