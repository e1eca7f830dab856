"""Training CLI: ``python -m ivid_tpu_torch.train --config CONFIG``.

The port of the repo's ``train.py``: a JSON config
(``backbone``/``framework``/``dataset``/``trainer``), the dataset, backbone,
framework and trainer built from their registries, an optional resume
(``--ckpt STEP`` or ``latest``, from ``--load_dir`` or the run directory),
and the run directory ``{output_dir}/{config name}`` with ``command.txt``,
``config.json``, ``model_summary.txt``, ``log.txt``, ``ckpts/`` and
``samples/``. ``--device`` (default ``cuda``) picks the device; the CPU runs
the kernels' plain versions.

``--ckpt`` also resumes a run of the root ``train.py`` (JAX): ``--load_dir``
its run directory, whose ``ckpts/`` hold ``.msgpack`` files (the trainer's
``load`` says what carries over); the port's own checkpoints stay ``.pt``.
``--profile_dir DIR`` runs the first 3 steps (real optimizer steps, counted)
under torch.profiler and writes a Chrome trace, with the trainer's spans
(``trainer.step`` and its stages), into ``DIR``.

Data parallel, one process per GPU::

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m ivid_tpu_torch.train --config CONFIG --data_dir DIR --distributed

``--distributed`` joins the process group that the launcher's environment
describes and leaves it when training ends: with ``--device cuda`` NCCL on
``cuda:LOCAL_RANK`` (one rank per card), with ``--device cuda:K`` gloo with
every rank on card K, with ``--device cpu`` gloo. ``--model_parallel M``
(tensor parallelism, the root ``train.py``'s flag) splits the N ranks into
an ``(N/M, M)`` mesh: each group of M ranks holds one model between them
(``parallel/tensor.py``), and the N/M groups are data parallel. The
checkpoints hold full tensors whatever M is. ``--num_workers`` and
``--worker_mode`` set the loader's workers (the trainer's defaults: 4
threads).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True, help="config JSON file")
    p.add_argument("--output_dir", type=str, default="results", help="output root")
    p.add_argument("--data_dir", type=str, default="data", help="dataset root")
    p.add_argument("--load_dir", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None, help="step to resume, or 'latest'")
    p.add_argument("--max_steps", type=int, default=None, help="override the config")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--distributed", action="store_true",
                   help="one process per rank, from torch.distributed.run")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor parallelism: ranks per model (needs --distributed)")
    p.add_argument("--num_workers", type=int, default=None, help="loader workers")
    p.add_argument("--worker_mode", choices=["thread", "process"], default=None,
                   help="loader workers as threads or spawned processes")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="trace the first steps with torch.profiler into this directory")
    return p.parse_args(argv)


def main(argv=None, record=None):
    """Build everything, resume if asked, train; returns the trainer.
    ``record``, a ``StepRecord``, keeps the run's per-step losses (and
    times)."""
    opt = parse_args(argv)
    from ivid_tpu_torch import parallel

    if opt.distributed:
        device = parallel.init_from_env(opt.device)
    else:
        device = torch.device(opt.device)
    try:
        return _train(opt, argv, device, record)
    finally:
        if opt.distributed:
            parallel.shutdown()


def _train(opt, argv, device, record):
    from ivid_tpu_torch import parallel
    from ivid_tpu_torch.config import Config, build_backbone, build_framework_from_config
    from ivid_tpu_torch.data import build_dataset
    from ivid_tpu_torch.training import checkpoint as ckpt_io
    from ivid_tpu_torch.training.trainer import TRAINERS

    is_main = parallel.rank() == 0
    cfg = Config.load(opt.config)
    name = os.path.splitext(os.path.basename(opt.config))[0]
    output_dir = os.path.join(opt.output_dir, name)
    if is_main:
        os.makedirs(output_dir, exist_ok=True)

    # Rank 0 lists the files (and writes the listing's cache) first.
    if not is_main:
        parallel.barrier()
    dataset = build_dataset(cfg.dataset, opt.data_dir)
    if is_main:
        parallel.barrier()
    cfg.resolve_num_classes(dataset.num_classes)
    trainer_args = dict(cfg.trainer.get("args", {}))
    for key in ("max_steps", "num_workers", "worker_mode"):
        if getattr(opt, key) is not None:
            trainer_args[key] = getattr(opt, key)
    if cfg.trainer["name"] not in TRAINERS:
        raise NotImplementedError(f"trainer {cfg.trainer['name']!r} is not ported yet")
    trainer_cls = TRAINERS[cfg.trainer["name"]]

    # The initial weights follow the trainer's seed.
    torch.manual_seed(int(trainer_args.get("seed", 0)))
    model = build_backbone(cfg).to(device)
    if is_main:
        # Of the whole model, before a trainer shards it.
        write_summary(os.path.join(output_dir, "model_summary.txt"), model, dataset)
    framework = build_framework_from_config(cfg, model, device=device)
    trainer = trainer_cls(framework, dataset, output_dir, device=device,
                          model_parallel=opt.model_parallel, **trainer_args)
    trainer.record = record
    try:
        if is_main:
            with open(os.path.join(output_dir, "command.txt"), "a") as f:
                print(" ".join(sys.argv if argv is None else ["ivid_tpu_torch.train", *argv]),
                      file=f)
            cfg.save(os.path.join(output_dir, "config.json"))

        step = opt.ckpt
        if step == "latest":
            step = ckpt_io.find_latest_step(opt.load_dir or output_dir)
        if step is not None:
            trainer.load(opt.load_dir or output_dir, int(step))
            if is_main:
                print(f"Resumed from step {trainer.step}")
        if opt.profile_dir:
            profile_steps(trainer, opt.profile_dir)
        trainer.run()
    finally:
        trainer.close()
    return trainer


def write_summary(path, model, dataset):
    """``model_summary.txt`` of a batch-1 forward; best-effort, as the root
    ``train.py``'s: a failure prints a line and training goes on."""
    from ivid_tpu_torch.utils.summary import model_summary

    s = dataset.image_size
    example = (torch.zeros((1, s, s, model.in_channels)), torch.zeros((1,), dtype=torch.long),
               torch.zeros((1,), dtype=torch.long) if model.num_classes else None)
    try:
        text = model_summary(model, example)
    except Exception as e:  # noqa: BLE001 -- the summary must not stop training
        print(f"model summary failed: {type(e).__name__}: {e}")
        return
    with open(path, "w") as f:
        f.write(text)


PROFILED_STEPS = 3


def profile_steps(trainer, profile_dir):
    """:data:`PROFILED_STEPS` optimizer steps under torch.profiler (counted
    in ``trainer.step``), the trace written into ``profile_dir``."""
    from ivid_tpu_torch import parallel
    from ivid_tpu_torch.utils.profiling import trace

    cuda = trainer.device.type == "cuda"
    with trace(profile_dir, cuda=cuda, rank=parallel.rank()):
        for _ in range(PROFILED_STEPS):
            trainer.run_step()
            trainer.step += 1
        if cuda:
            torch.cuda.synchronize(trainer.device)
    print(f"profiler trace written to {profile_dir} ({PROFILED_STEPS} steps profiled; "
          f"trainer resumes at step {trainer.step})")


if __name__ == "__main__":
    main()
