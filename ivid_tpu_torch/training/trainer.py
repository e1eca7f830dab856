"""Trainers: diffusion training with AdamW, EMA, gradient accumulation,
checkpointing, logging and sample grids.

Port of ``ivid_tpu/training/trainer.py`` (``BasicTrainer``,
``InpaintTrainer``, ``SuperResTrainer``), on one device or over the
``(data, model)`` mesh of ``torch.distributed`` ranks (one process each):

- Parameters stay in f32; a bf16 torso casts them per call (``models/adm.py``).
- AdamW with optax's defaults (betas 0.9/0.999, eps 1e-8) and the config's
  ``weight_decay``, decoupled as optax applies it.
- One EMA copy per rate, ``ema = ema·rate + param·(1−rate)`` after every step.
- ``batch_split`` microbatches accumulate gradients (each microbatch's loss
  draws from ``fold_in(i)`` of the step's loss source), then average them.
- Every random draw goes through the noise source (``diffusion/noise.py``) in
  the JAX package's key derivation, so a source that replays JAX keys gives
  the JAX trainer's steps.
- A checkpoint holds the model, the EMAs, and the optimizer state, step,
  noise-source state and loader cursor, so a resumed run repeats the loss
  sequence of an uninterrupted one. ``load`` also resumes a JAX package
  run from its ``.msgpack`` files (``load`` says what carries over).
- The inpaint trainer synthesizes its warp conditioning on the device in
  every step (``training/warp_cond.py``), the warp batched over the batch,
  or, with ``warp_host``, takes it from loader workers that warp on the CPU
  (``data/warp_host.py``).
- Parallel (a process group is up): the ranks form a ``(data, model)``
  mesh of ``world/model_parallel × model_parallel``
  (``parallel.make_groups``). With ``model_parallel > 1`` each model group
  holds one model between its ranks (``parallel.tensor.shard_unet``: the
  full model, built the same on every rank, replaced by this rank's
  slices), and AdamW and the EMAs work on the slices. The batch is global,
  ``batch_size_per_gpu × data size``; each data rank loads its own rows
  (the loader's shards), which its model peers share, and the model runs
  through ``DistributedDataParallel`` over the data group, which averages
  the gradients (the first ``batch_split − 1`` micro-batches under
  ``no_sync``). Every rank derives the step's noise as one device would for
  the global batch and keeps its data rank's rows
  (``parallel.RowShardNoise``, and the warp's per-sample sources split over
  the global batch), so a run on N ranks takes the steps of one rank at the
  same global batch. Parameters are checked across ranks at set-up, after
  every load and every ``i_ddpcheck`` steps (a replicated one bit-equal on
  every rank, a slice on its data group). Checkpoints hold full tensors,
  gathered over the model group, so their files do not depend on
  ``model_parallel``; a load reads them whole and keeps this rank's slices.
  Saving and sampling are collective: every rank runs them in lockstep
  (sampling with the unwrapped model), as the JAX trainer does, and only
  rank 0 writes logs, checkpoints and sample grids.
- The inpaint and super-resolution trainers can start from a checkpoint of a
  model with fewer input channels (``finetune_ckpt``): its first convolution
  is zero-padded (``checkpoint.finetune_load``), and the EMA copies start
  from the loaded weights too (the JAX package's keep their initial values).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ivid_tpu_torch import parallel
from ivid_tpu_torch.data.loader import DataLoader
from ivid_tpu_torch.data.warp_host import HostWarpDataset
from ivid_tpu_torch.diffusion import samplers
from ivid_tpu_torch.diffusion.noise import KeyedNoise
from ivid_tpu_torch.parallel import tensor as tp
from ivid_tpu_torch.training import checkpoint as ckpt_io
from ivid_tpu_torch.training import warp_cond
from ivid_tpu_torch.utils.images import save_image_grid
from ivid_tpu_torch.utils.profiling import span


class StepRecord:
    """What a caller asks a trainer to keep of the steps it runs
    (``trainer.record = StepRecord()``): each step's loss as a device scalar
    (no host sync per step), the seconds the step waited for the loader's
    items, and, with ``timing`` on CUDA, CUDA events at the boundaries of the
    step's stages. The trainer marks the same stages as spans,
    ``trainer.<stage>``, whether or not it keeps a record (the span of
    ``data_and_warp`` covers the conditioning alone: the loader's wait is
    ``trainer.loader_wait``, and the batch's copy to the device lies between
    them)."""

    STAGES = ("data_and_warp", "forward", "backward", "optimizer")

    def __init__(self, timing: bool = False):
        self.timing = timing
        self.losses = []
        self.loader_waits = []
        self.events = []

    def stage_ms(self) -> list:
        """Per timed step: ms of each stage and of the whole ``step``."""
        if self.events:
            torch.cuda.synchronize()
        out = []
        for ev in self.events:
            ms = {k: a.elapsed_time(b) for k, a, b in zip(self.STAGES, ev, ev[1:])}
            ms["step"] = ev[0].elapsed_time(ev[-1])
            out.append(ms)
        return out


class BasicTrainer:
    def __init__(
        self,
        framework,
        dataset,
        output_dir: str,
        *,
        max_steps: int,
        batch_size: Optional[int] = None,
        batch_size_per_gpu: Optional[int] = None,
        batch_split: Optional[int] = None,
        learning_rate: float = 1e-4,
        weight_decay: float = 0.0,
        ema_rate=0.9999,
        i_print: int = 1000,
        i_log: int = 500,
        i_sample: int = 10000,
        i_save: int = 10000,
        i_ddpcheck: int = 10000,
        sample_at_init: bool = True,
        model_parallel: int = 1,
        num_workers: int = 4,
        worker_mode: str = "thread",
        seed: int = 0,
        device="cuda",
        noise=None,
        # Accepted for the reference configs' sake; bf16 needs no loss scaling.
        fp16_mode: Optional[str] = None,
        fp16_scale_growth: float = 1e-3,
    ):
        """``batch_size`` is the global batch; ``batch_size_per_gpu``, where
        given, makes it ``batch_size_per_gpu × data size`` (the world over
        ``model_parallel``). ``model_parallel`` ranks hold one model between
        them (tensor parallelism; it must divide the process group's size).
        ``num_workers`` and ``worker_mode`` ("thread" or "process") set the
        loader's workers. ``noise`` is the noise source
        (default: a :class:`KeyedNoise` seeded with ``seed + 1``; data
        parallel runs need one whose ``split`` gives distinct sources)."""
        del fp16_mode, fp16_scale_growth
        if batch_size is None and batch_size_per_gpu is None:
            raise ValueError("give batch_size or batch_size_per_gpu")
        self.framework = framework
        self.model = framework.model
        self.dataset = dataset
        self.output_dir = output_dir
        self.max_steps = max_steps
        self.rank, self.world = parallel.rank(), parallel.world_size()
        self.is_main = self.rank == 0
        self.groups = parallel.make_groups(model_parallel)
        self.data_rank, self.data_size = self.groups.data_rank, self.groups.data_size
        self.batch_size = (batch_size_per_gpu * self.data_size if batch_size_per_gpu is not None
                           else batch_size)
        if self.batch_size % self.data_size:
            raise ValueError(f"global batch {self.batch_size} not divisible by {self.data_size} "
                             "data ranks")
        self.local_batch_size = self.batch_size // self.data_size
        self.batch_split = batch_split or 1
        if self.local_batch_size % self.batch_split:
            raise ValueError(f"batch {self.local_batch_size} per rank not divisible by split "
                             f"{self.batch_split}")
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.ema_rate = [ema_rate] if isinstance(ema_rate, float) else list(ema_rate)
        self.i_print = i_print
        self.i_log = i_log
        self.i_sample = i_sample
        self.i_save = i_save
        self.i_ddpcheck = i_ddpcheck
        self.sample_at_init = sample_at_init
        self.num_workers = num_workers
        self.worker_mode = worker_mode
        self.seed = seed
        self.device = torch.device(device)
        if self.is_main:
            os.makedirs(os.path.join(output_dir, "ckpts"), exist_ok=True)
            os.makedirs(os.path.join(output_dir, "samples"), exist_ok=True)

        self.step = 0
        self.model.to(self.device).train()
        #: this rank's sharded parameters by name (``parallel.tensor.Shard``);
        #: empty without tensor parallelism.
        self.tp_specs = tp.shard_unet(self.model, self.groups)
        #: the model behind DistributedDataParallel over the data group when a
        #: process group is up (also at world size 1), else None.
        self.ddp = None
        if torch.distributed.is_initialized():
            self.ddp = torch.nn.parallel.DistributedDataParallel(
                self.model, device_ids=[self.device] if self.device.type == "cuda" else None,
                process_group=self.groups.data)
        self.params = dict(self.model.named_parameters())
        self.optimizer = torch.optim.AdamW(
            self.params.values(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
        self.ema_params = [
            {k: p.detach().clone() for k, p in self.params.items()} for _ in self.ema_rate
        ]
        self.rng = noise if noise is not None else KeyedNoise.seeded(seed + 1, self.device)
        #: a :class:`StepRecord` that keeps every step's loss (and times), or
        #: None: the trainer itself keeps nothing per step.
        self.record: Optional[StepRecord] = None
        self.loader = None
        self._build_loader()
        self.check_replication()
        if self.is_main:
            self._print_banner()

    # ---- set-up ----

    def _loader_dataset(self):
        """Hook: the dataset the loader reads (trainers may wrap it)."""
        return self.dataset

    def _build_loader(self, start=(0, 0)):
        if self.loader is not None:
            self.loader.close()
        self._loader_obj = DataLoader(
            self._loader_dataset(), self.batch_size, num_workers=self.num_workers,
            worker_mode=self.worker_mode, seed=self.seed, shard_index=self.data_rank,
            num_shards=self.data_size, start=tuple(int(x) for x in start))
        self.loader = iter(self._loader_obj)

    def check_replication(self):
        """``parallel.check_replication`` of the model's parameters, its
        slices held within their data groups. Collective."""
        parallel.check_replication(self.model.named_parameters(), self.tp_specs,
                                   self.groups.model_size)

    def close(self):
        """Stop the loader's workers; a later step starts them again at the
        loader's cursor."""
        if self.loader is not None:
            self.loader.close()
            self.loader = None

    def _device_batch(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.asarray(v))
            out[k] = (t.long() if k == "classes" else t).to(self.device)
        return out

    # ---- the step ----

    def prepare_batch(self, batch: dict, rng) -> dict:
        """Hook: trainers transform the device batch (e.g. warp)."""
        del rng
        return batch

    def _train_step(self, batch: dict, rng, events=None) -> dict:
        """One step on a device batch. ``events``, when given, are the five
        CUDA events of :attr:`StepRecord.STAGES`' boundaries; this records
        the middle three (conditioning, loss and backward done). Each stage
        is also a span, ``trainer.<stage>`` (a forward and a backward for
        each microbatch)."""
        mark = (lambda i: events[i].record()) if events is not None else (lambda i: None)
        rng_prep, rng_loss = rng.split()
        with span("trainer.data_and_warp"):
            batch = self.prepare_batch(batch, rng_prep)
        mark(1)
        if self.data_size > 1:
            rng_loss = parallel.RowShardNoise(rng_loss, self.data_rank, self.data_size)
        self.optimizer.zero_grad(set_to_none=True)
        if self.batch_split > 1:
            # Forward and backward interleave: "loss done" is the last
            # microbatch's. The ranks average the gradients once, in the
            # last microbatch's backward.
            n = self.batch_split
            micro = {k: v.reshape((n, -1) + v.shape[1:]) for k, v in batch.items()}
            per = []
            for i in range(n):
                sync = (contextlib.nullcontext() if self.ddp is None or i == n - 1
                        else self.ddp.no_sync())
                with sync:
                    with span("trainer.forward"):
                        loss, metrics = self._loss(rng_loss.fold_in(i),
                                                   {k: v[i] for k, v in micro.items()})
                    if i == n - 1:
                        mark(2)
                    with span("trainer.backward"):
                        loss.backward()
                per.append(metrics)
            for p in self.params.values():
                if p.grad is not None:
                    p.grad.div_(n)
            metrics = {k: torch.stack([m[k] for m in per]).mean() for k in per[0]}
        else:
            with span("trainer.forward"):
                loss, metrics = self._loss(rng_loss, batch)
            mark(2)
            with span("trainer.backward"):
                loss.backward()
        mark(3)
        with span("trainer.optimizer"):
            self.optimizer.step()
            self.update_ema()
        return metrics

    def _loss(self, rng, batch):
        """The framework's training loss, its forward through the DDP
        wrapper when there is one (whose backward hooks average the
        gradients over the ranks)."""
        if self.ddp is None:
            return self.framework.training_loss(rng, batch)
        self.framework.model = self.ddp
        try:
            return self.framework.training_loss(rng, batch)
        finally:
            self.framework.model = self.model

    @torch.no_grad()
    def update_ema(self):
        """``ema = ema·rate + param·(1−rate)`` for every rate."""
        params = list(self.params.values())
        for rate, ema in zip(self.ema_rate, self.ema_params):
            vals = list(ema.values())
            torch._foreach_mul_(vals, rate)
            torch._foreach_add_(vals, params, alpha=1.0 - rate)

    def run_step(self) -> dict:
        """One training step: the loader's next batch, the step, and what
        :attr:`record` keeps. Under torch.profiler the span ``trainer.step``
        around ``trainer.loader_wait`` and the stages' spans."""
        with span("trainer.step"):
            rec = self.record
            events = None
            if rec is not None and rec.timing and self.device.type == "cuda":
                events = tuple(torch.cuda.Event(enable_timing=True)
                               for _ in range(len(StepRecord.STAGES) + 1))
                events[0].record()
            if self.loader is None:
                self._build_loader(start=self._loader_obj.position)
            waited = self._loader_obj.wait_seconds
            with span("trainer.loader_wait"):
                items = next(self.loader)
            batch = self._device_batch(items)
            self.rng, step_rng = self.rng.split()
            metrics = self._train_step(batch, step_rng, events)
            if rec is not None:
                if events is not None:
                    events[-1].record()
                    rec.events.append(events)
                rec.losses.append(metrics["loss"])
                rec.loader_waits.append(self._loader_obj.wait_seconds - waited)
            return metrics

    # ---- checkpoints ----

    def _full(self, state: dict) -> dict:
        """``state`` (tensors by parameter name) with this rank's slices
        gathered into full tensors. Collective over the model group."""
        return tp.gather_state_dict(state, self.tp_specs, self.groups) if self.tp_specs else state

    def _slices(self, state: dict) -> dict:
        """``state`` of full tensors cut to this rank's slices."""
        return tp.shard_state_dict(state, self.tp_specs, self.groups) if self.tp_specs else state

    def _map_moments(self, opt_state: dict, fn) -> dict:
        """``opt_state`` (AdamW's state dict) with ``fn`` applied to its
        ``exp_avg`` and ``exp_avg_sq`` (each a dict by parameter name)."""
        names = list(self.params)
        out = dict(opt_state, state=dict(opt_state["state"]))
        for key in ("exp_avg", "exp_avg_sq"):
            moments = fn({names[i]: st[key] for i, st in opt_state["state"].items()})
            for i in opt_state["state"]:
                out["state"][i] = dict(out["state"][i], **{key: moments[names[i]]})
        return out

    def save(self):
        """Collective: every rank gathers its slices (over the model group);
        rank 0 writes full tensors, the files a ``model_parallel=1`` run
        writes. EMAs and misc first, the model last (see ``checkpoint.py``)."""
        emas = [{k: v.cpu() for k, v in self._full(ema).items()} for ema in self.ema_params]
        optimizer = self._map_moments(self.optimizer.state_dict(), self._full)
        model = self._full(self.model.state_dict())
        if not self.is_main:
            return
        for rate, ema in zip(self.ema_rate, emas):
            ckpt_io.save(ckpt_io.ema_path(self.output_dir, rate, self.step), ema)
        misc = {
            "optimizer": optimizer,
            "step": self.step,
            "rng": self.rng.state_dict(),
            "loader_pos": list(self._loader_obj.position),
            "ema_rates": list(self.ema_rate),
        }
        ckpt_io.save(ckpt_io.misc_path(self.output_dir, self.step), misc)
        ckpt_io.save(ckpt_io.model_path(self.output_dir, self.step), model)

    def load(self, load_dir: str, step: int):
        """Resume from the checkpoint of ``step`` (every rank reads the full
        tensors and keeps its slices): the port's ``.pt`` files, or a JAX
        package run's ``.msgpack`` files (:meth:`_load_jax`)."""
        if ckpt_io.step_suffix(load_dir, step) == ckpt_io.MSGPACK:
            self._load_jax(load_dir, step)
        else:
            self.model.load_state_dict(self._slices(
                ckpt_io.load(ckpt_io.model_path(load_dir, step))))
            misc = ckpt_io.load(ckpt_io.misc_path(load_dir, step))
            self._check_ema_rates(misc["ema_rates"])
            for i, rate in enumerate(self.ema_rate):
                ema = self._slices(ckpt_io.load(ckpt_io.ema_path(load_dir, rate, step)))
                self.ema_params[i] = {k: v.to(self.device) for k, v in ema.items()}
            self.optimizer.load_state_dict(self._map_moments(misc["optimizer"], self._slices))
            self.step = int(misc["step"])
            self.rng.load_state_dict(misc["rng"])
            self._build_loader(start=misc["loader_pos"])
        self.check_replication()

    def _check_ema_rates(self, rates):
        if [float(r) for r in rates] != [float(r) for r in self.ema_rate]:
            raise ValueError(f"checkpoint EMA rates {list(rates)} != trainer {self.ema_rate}")

    def _load_jax(self, load_dir: str, step: int):
        """Resume a JAX package run: the model and every EMA copy, AdamW's
        moments and step (optax's ``mu``, ``nu`` and ``count``), the step
        and the loader's cursor. The JAX PRNG key cannot continue as the
        port's noise: the noise source becomes a :class:`KeyedNoise`
        derived from the key's two words (``KeyedNoise.from_jax_key``), so
        the resumed run's draws are the port's own, the same on every
        resume of that file, not the JAX run's."""
        arch = self.model.arch_args
        self.model.load_state_dict(self._slices(ckpt_io.load_model_state(
            ckpt_io.model_path(load_dir, step, ckpt_io.MSGPACK), arch)))
        misc = ckpt_io.read_jax_misc(ckpt_io.misc_path(load_dir, step, ckpt_io.MSGPACK), arch)
        self._check_ema_rates(misc["ema_rates"])
        for i, rate in enumerate(self.ema_rate):
            ema = self._slices(ckpt_io.load_model_state(
                ckpt_io.ema_path(load_dir, rate, step, ckpt_io.MSGPACK), arch))
            self.ema_params[i] = {k: ema[k].to(self.device) for k in self.params}
        exp_avg, exp_avg_sq = self._slices(misc["exp_avg"]), self._slices(misc["exp_avg_sq"])
        self.optimizer.state.clear()
        for k, p in self.params.items():
            self.optimizer.state[p] = {
                "step": torch.tensor(float(misc["adam_step"]), dtype=torch.float32),
                "exp_avg": exp_avg[k].to(p.device),
                "exp_avg_sq": exp_avg_sq[k].to(p.device),
            }
        self.step = misc["step"]
        self.rng = KeyedNoise.from_jax_key(misc["rng"], self.device)
        if self.is_main:
            print(f"JAX PRNG key {misc['rng']} of {load_dir} step {step}: noise continues "
                  "from a KeyedNoise derived from it (the port's draws, not the JAX run's)")
        self._build_loader(start=misc["loader_pos"])

    # ---- sample grids ----

    def _visualization_batch(self, num_samples: int) -> dict:
        idx = np.random.default_rng(1234 + self.step).choice(
            len(self.dataset), size=min(num_samples, len(self.dataset)), replace=False)
        items = [self.dataset[int(i)] for i in idx]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def sample(self, suffix: Optional[str] = None, num_samples: int = 25,
               batch_size: int = 25):
        if suffix is None:
            suffix = f"step{self.step:07d}"
        s = self.dataset.image_size
        outs = []
        for i in range(0, num_samples, batch_size):
            b = min(batch_size, num_samples - i)
            rng = self.rng.fold_in(10_000 + i)
            cond, guidance = None, 0.0
            if self.model.num_classes:
                classes = rng.fold_in(1).randint((b,), 0, self.model.num_classes)
                cond, guidance = {"classes": classes.to(self.device)}, 3.0
            out = samplers.ddim_sample(self.framework, rng, num=b, image_size=s, cond=cond,
                                       guidance=guidance,
                                       steps=min(250, self.framework.schedule.timesteps))
            outs.append(out["samples"].cpu().numpy())
        if not self.is_main:
            return
        imgs = np.concatenate(outs, axis=0)
        nrow = int(np.sqrt(num_samples))
        d = os.path.join(self.output_dir, "samples")
        save_image_grid(os.path.join(d, f"rgb_{suffix}.png"), imgs[..., :3], nrow=nrow)
        if imgs.shape[-1] == 4:
            save_image_grid(os.path.join(d, f"depth_{suffix}.png"), imgs[..., 3:], nrow=nrow)

    # ---- the loop ----

    def _collective(self, fn):
        """``fn()`` on every rank in lockstep (the model peers' collectives
        need each other; only rank 0 writes), then a barrier, so that no
        rank reads a file before it is written."""
        fn()
        parallel.barrier()

    def run(self):
        if self.step == 0 and self.sample_at_init:
            self._collective(lambda: self.sample(suffix="init"))
        log = []
        elapsed = 0.0
        log_file = open(os.path.join(self.output_dir, "log.txt"), "a") if self.is_main else None
        try:
            while self.step < self.max_steps:
                t0 = time.time()
                metrics = self.run_step()
                self.step += 1
                report = self.step % self.i_log == 0 or (
                    self.i_print and self.step % self.i_print == 0)
                # The logged metrics are the global batch's: the ranks' means.
                values = ({k: float(parallel.mean_over_ranks(v)) for k, v in metrics.items()}
                          if report else None)
                dt = time.time() - t0
                elapsed += dt
                if self.i_ddpcheck and self.step % self.i_ddpcheck == 0:
                    self.check_replication()
                if self.is_main:
                    log.append((self.step, {
                        "time": {"step": dt, "elapsed": elapsed},
                        "loss": values if self.step % self.i_log == 0 else None,
                    }))
                    if self.i_print and self.step % self.i_print == 0:
                        print(f"step {self.step}/{self.max_steps} loss {values['loss']:.4f} "
                              f"({dt * 1000:.0f} ms/step, {elapsed:.0f}s elapsed)", flush=True)
                    if self.step % self.i_log == 0:
                        for st, rec in log:
                            print(f"{st}: {json.dumps(rec)}", file=log_file)
                        log_file.flush()
                        log = []
                if self.step % self.i_save == 0:
                    self._collective(self.save)
                if self.step % self.i_sample == 0:
                    self._collective(self.sample)
        finally:
            if log_file is not None:
                log_file.close()

    def _print_banner(self):
        print("\nTrainer initialized.")
        print(f"  - Backbone: {self.model.__class__.__name__}")
        print(f"  - Framework: {self.framework.__class__.__name__}")
        print(f"  - Dataset: {self.dataset.__class__.__name__}")
        print(f"  - Device: {self.device}, ranks: {self.world}")
        print(f"  - Mesh: {{data: {self.data_size}, model: {self.groups.model_size}}}")
        print(f"  - Batch size: {self.batch_size} ({self.local_batch_size} per rank)")
        print(f"  - Batch split: {self.batch_split}")
        print(f"  - LR / WD: {self.learning_rate} / {self.weight_decay}")
        print(f"  - EMA rates: {self.ema_rate}")


class FinetuneMixin:
    """Start from a checkpoint whose first convolution may have fewer input
    channels, zero-padded to the model's."""

    def finetune_from(self, finetune_ckpt: str):
        """``finetune_ckpt``: a model or EMA file, the port's ``.pt``, a
        reference state dict or the JAX package's ``.msgpack``."""
        state = ckpt_io.finetune_load(finetune_ckpt, self._full(self.model.state_dict()),
                                      self.model.arch_args)
        self.model.load_state_dict(self._slices(state))
        with torch.no_grad():
            for ema in self.ema_params:
                for k, v in ema.items():
                    v.copy_(self.params[k])
        self.check_replication()
        if self.is_main:
            print(f"Finetuning from {finetune_ckpt}")


class InpaintTrainer(FinetuneMixin, BasicTrainer):
    """Conditional-completion trainer with warp conditioning synthesized on
    the device in every step, or, with ``warp_host``, in the loader's
    workers on the CPU (:class:`HostWarpDataset`; the sample grids still warp
    on the device). ``backbone_args`` is accepted for the configs' sake: the
    JAX package needs a reference checkpoint's architecture to rename its
    weights, and the port reads them by their names."""

    def __init__(self, framework, dataset, output_dir, *, finetune_ckpt=None,
                 backbone_args=None, warp_host=False, **kwargs):
        del backbone_args
        self.augments = tuple(getattr(dataset, "augments", ()))
        self.pose_std = float(getattr(dataset, "std", 0.15))
        self.near = float(getattr(dataset, "near", 0.5))
        self.far = float(getattr(dataset, "far", 100.0))
        self.warp_host = bool(warp_host)
        super().__init__(framework, dataset, output_dir, **kwargs)
        if finetune_ckpt:
            self.finetune_from(finetune_ckpt)

    def _loader_dataset(self):
        if not self.warp_host:
            return self.dataset
        return HostWarpDataset(self.dataset, augments=self.augments, pose_std=self.pose_std,
                               near=self.near, far=self.far, seed=self.seed)

    def prepare_batch(self, batch, rng):
        """The warp conditioning of this data rank's rows: one source per row
        of the global batch (``rng.split(global batch)``), this data rank's
        block kept. With ``warp_host`` the loader attached it already."""
        if self.warp_host:
            return batch
        b = batch["x_0"].shape[0]
        d = self.data_rank
        rows = rng.split(b * self.data_size)[d * b:(d + 1) * b]
        return self._synthesize(batch, rows)

    def synthesize_cond(self, batch, rng):
        """Random orbit pose, forward-backward warp and augments per sample
        (one noise source each, ``rng.split(B)``); adds ``y``, ``mask``,
        ``mask_rgb`` (with erode_rgb) and ``pose`` to the batch."""
        return self._synthesize(batch, rng.split(batch["x_0"].shape[0]))

    def _synthesize(self, batch, rngs):
        x01 = batch["x_0"] * 0.5 + 0.5  # datasets normalize to [-1, 1]
        warped = warp_cond.synthesize_batch(
            x01, rngs, augments=self.augments, pose_std=self.pose_std,
            near=self.near, far=self.far,
        )
        out = dict(batch)
        out.update(warped)
        return out

    def sample(self, suffix: Optional[str] = None, num_samples: int = 25,
               batch_size: int = 25):
        if suffix is None:
            suffix = f"step{self.step:07d}"
        batch = self._visualization_batch(num_samples)
        num_samples = len(next(iter(batch.values())))
        rng = self.rng.fold_in(20_000 + self.step)
        cond = self.synthesize_cond(self._device_batch(batch), rng.fold_in(0))
        out = samplers.ddim_sample(
            self.framework, rng, num=num_samples, image_size=self.dataset.image_size,
            cond=cond, guidance=3.0 if self.model.num_classes else 0.0,
            steps=min(250, self.framework.schedule.timesteps),
        )
        if not self.is_main:
            return
        host = lambda x: x.detach().cpu().numpy()
        imgs, y = host(out["samples"]), host(cond["y"])
        nrow = int(np.sqrt(num_samples))
        d = os.path.join(self.output_dir, "samples")
        grid = lambda name, x, **kw: save_image_grid(os.path.join(d, f"{name}_{suffix}.png"), x,
                                                     nrow=nrow, **kw)
        grid("mask", host(cond["mask"]), value_range=(0, 1))
        grid("rgb_gt", batch["x_0"][..., :3])
        grid("rgb_cond", y[..., :3])
        grid("rgb", imgs[..., :3])
        grid("depth_gt", batch["x_0"][..., 3:])
        grid("depth_cond", y[..., 3:])
        grid("depth", imgs[..., 3:])
        if "mask_rgb" in cond:
            grid("mask_rgb", host(cond["mask_rgb"]), value_range=(0, 1))


class SuperResTrainer(FinetuneMixin, BasicTrainer):
    """Super-resolution trainer: the dataset's items carry the low-resolution
    ``y`` that the framework (``SuperResCFG``) packs. ``backbone_args`` is
    accepted as by :class:`InpaintTrainer`."""

    def __init__(self, framework, dataset, output_dir, *, finetune_ckpt=None,
                 backbone_args=None, **kwargs):
        del backbone_args
        super().__init__(framework, dataset, output_dir, **kwargs)
        if finetune_ckpt:
            self.finetune_from(finetune_ckpt)

    def sample(self, suffix: Optional[str] = None, num_samples: int = 9,
               batch_size: int = 9):
        """50 guided DDIM steps (guidance 3 with classes) conditioned on a
        visualization batch's ``y``; writes the ground truth, condition and
        sample grids of RGB and depth."""
        if suffix is None:
            suffix = f"step{self.step:07d}"
        batch = self._visualization_batch(num_samples)
        num_samples = len(next(iter(batch.values())))
        cond = self._device_batch({k: v for k, v in batch.items() if k != "x_0"})
        rng = self.rng.fold_in(30_000 + self.step)
        out = samplers.ddim_sample(
            self.framework, rng, num=num_samples, image_size=self.dataset.image_size,
            cond=cond, guidance=3.0 if self.model.num_classes else 0.0,
            steps=min(50, self.framework.schedule.timesteps),
        )
        if not self.is_main:
            return
        imgs = out["samples"].cpu().numpy()
        nrow = int(np.sqrt(num_samples))
        d = os.path.join(self.output_dir, "samples")
        for name, x in (("rgb_gt", batch["x_0"][..., :3]), ("rgb_cond", batch["y"][..., :3]),
                        ("rgb", imgs[..., :3]), ("depth_gt", batch["x_0"][..., 3:]),
                        ("depth_cond", batch["y"][..., 3:]), ("depth", imgs[..., 3:])):
            save_image_grid(os.path.join(d, f"{name}_{suffix}.png"), x, nrow=nrow)


TRAINERS = {
    "BasicTrainer": BasicTrainer,
    "InpaintTrainer": InpaintTrainer,
    "SuperResTrainer": SuperResTrainer,
}
