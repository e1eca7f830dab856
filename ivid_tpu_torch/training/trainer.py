"""Trainers: diffusion training with AdamW, EMA, gradient accumulation,
checkpointing, logging and sample grids.

Port of ``ivid_tpu/training/trainer.py`` (``BasicTrainer``,
``InpaintTrainer``, ``SuperResTrainer``) on one device:

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
  sequence of an uninterrupted one.
- The inpaint trainer synthesizes its warp conditioning on the device in
  every step (``training/warp_cond.py``), the warp batched over the batch.
- The inpaint and super-resolution trainers can start from a checkpoint of a
  model with fewer input channels (``finetune_ckpt``): its first convolution
  is zero-padded (``checkpoint.finetune_load``), and the EMA copies start
  from the loaded weights too (the JAX package's keep their initial values).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ivid_tpu_torch.data.loader import DataLoader
from ivid_tpu_torch.diffusion import samplers
from ivid_tpu_torch.diffusion.noise import TorchNoise
from ivid_tpu_torch.training import checkpoint as ckpt_io
from ivid_tpu_torch.training import warp_cond
from ivid_tpu_torch.utils.images import save_image_grid


class StepRecord:
    """What a caller asks a trainer to keep of the steps it runs
    (``trainer.record = StepRecord()``): each step's loss as a device scalar
    (no host sync per step) and, with ``timing`` on CUDA, CUDA events at the
    boundaries of the step's stages."""

    STAGES = ("data_and_warp", "forward", "backward", "optimizer")

    def __init__(self, timing: bool = False):
        self.timing = timing
        self.losses = []
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
        sample_at_init: bool = True,
        seed: int = 0,
        device="cuda",
        noise=None,
        # Accepted for the reference configs' sake; bf16 needs no loss scaling.
        fp16_mode: Optional[str] = None,
        fp16_scale_growth: float = 1e-3,
    ):
        del fp16_mode, fp16_scale_growth
        if batch_size is None and batch_size_per_gpu is None:
            raise ValueError("give batch_size or batch_size_per_gpu")
        self.framework = framework
        self.model = framework.model
        self.dataset = dataset
        self.output_dir = output_dir
        self.max_steps = max_steps
        self.batch_size = batch_size_per_gpu if batch_size_per_gpu is not None else batch_size
        self.batch_split = batch_split or 1
        if self.batch_size % self.batch_split:
            raise ValueError(f"batch {self.batch_size} not divisible by split {self.batch_split}")
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.ema_rate = [ema_rate] if isinstance(ema_rate, float) else list(ema_rate)
        self.i_print = i_print
        self.i_log = i_log
        self.i_sample = i_sample
        self.i_save = i_save
        self.sample_at_init = sample_at_init
        self.seed = seed
        self.device = torch.device(device)
        os.makedirs(os.path.join(output_dir, "ckpts"), exist_ok=True)
        os.makedirs(os.path.join(output_dir, "samples"), exist_ok=True)

        self.step = 0
        self.model.to(self.device).train()
        self.params = dict(self.model.named_parameters())
        self.optimizer = torch.optim.AdamW(
            self.params.values(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
        self.ema_params = [
            {k: p.detach().clone() for k, p in self.params.items()} for _ in self.ema_rate
        ]
        self.rng = noise if noise is not None else TorchNoise.seeded(seed + 1, self.device)
        #: a :class:`StepRecord` that keeps every step's loss (and times), or
        #: None: the trainer itself keeps nothing per step.
        self.record: Optional[StepRecord] = None
        self._build_loader()
        self._print_banner()

    # ---- set-up ----

    def _build_loader(self, start=(0, 0)):
        self._loader_obj = DataLoader(self.dataset, self.batch_size, seed=self.seed,
                                      start=tuple(int(x) for x in start))
        self.loader = iter(self._loader_obj)

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
        the middle three (conditioning, loss and backward done)."""
        mark = (lambda i: events[i].record()) if events is not None else (lambda i: None)
        rng_prep, rng_loss = rng.split()
        batch = self.prepare_batch(batch, rng_prep)
        mark(1)
        self.optimizer.zero_grad(set_to_none=True)
        if self.batch_split > 1:
            # Forward and backward interleave: "loss done" is the last
            # microbatch's.
            n = self.batch_split
            micro = {k: v.reshape((n, -1) + v.shape[1:]) for k, v in batch.items()}
            per = []
            for i in range(n):
                loss, metrics = self.framework.training_loss(
                    rng_loss.fold_in(i), {k: v[i] for k, v in micro.items()}
                )
                if i == n - 1:
                    mark(2)
                loss.backward()
                per.append(metrics)
            for p in self.params.values():
                if p.grad is not None:
                    p.grad.div_(n)
            metrics = {k: torch.stack([m[k] for m in per]).mean() for k in per[0]}
        else:
            loss, metrics = self.framework.training_loss(rng_loss, batch)
            mark(2)
            loss.backward()
        mark(3)
        self.optimizer.step()
        self.update_ema()
        return metrics

    @torch.no_grad()
    def update_ema(self):
        """``ema = ema·rate + param·(1−rate)`` for every rate."""
        params = list(self.params.values())
        for rate, ema in zip(self.ema_rate, self.ema_params):
            vals = list(ema.values())
            torch._foreach_mul_(vals, rate)
            torch._foreach_add_(vals, params, alpha=1.0 - rate)

    def run_step(self) -> dict:
        rec = self.record
        events = None
        if rec is not None and rec.timing and self.device.type == "cuda":
            events = tuple(torch.cuda.Event(enable_timing=True)
                           for _ in range(len(StepRecord.STAGES) + 1))
            events[0].record()
        batch = self._device_batch(next(self.loader))
        self.rng, step_rng = self.rng.split()
        metrics = self._train_step(batch, step_rng, events)
        if rec is not None:
            if events is not None:
                events[-1].record()
                rec.events.append(events)
            rec.losses.append(metrics["loss"])
        return metrics

    # ---- checkpoints ----

    def save(self):
        """EMAs and misc first, the model last (see ``checkpoint.py``)."""
        for rate, ema in zip(self.ema_rate, self.ema_params):
            ckpt_io.save(ckpt_io.ema_path(self.output_dir, rate, self.step),
                         {k: v.cpu() for k, v in ema.items()})
        misc = {
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "rng": self.rng.state_dict(),
            "loader_pos": list(self._loader_obj.position),
            "ema_rates": list(self.ema_rate),
        }
        ckpt_io.save(ckpt_io.misc_path(self.output_dir, self.step), misc)
        ckpt_io.save(ckpt_io.model_path(self.output_dir, self.step), self.model.state_dict())

    def load(self, load_dir: str, step: int):
        self.model.load_state_dict(ckpt_io.load(ckpt_io.model_path(load_dir, step)))
        misc = ckpt_io.load(ckpt_io.misc_path(load_dir, step))
        if [float(r) for r in misc["ema_rates"]] != [float(r) for r in self.ema_rate]:
            raise ValueError(f"checkpoint EMA rates {misc['ema_rates']} != trainer {self.ema_rate}")
        for i, rate in enumerate(self.ema_rate):
            ema = ckpt_io.load(ckpt_io.ema_path(load_dir, rate, step))
            self.ema_params[i] = {k: v.to(self.device) for k, v in ema.items()}
        self.optimizer.load_state_dict(misc["optimizer"])
        self.step = int(misc["step"])
        self.rng.load_state_dict(misc["rng"])
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
        imgs = np.concatenate(outs, axis=0)
        nrow = int(np.sqrt(num_samples))
        d = os.path.join(self.output_dir, "samples")
        save_image_grid(os.path.join(d, f"rgb_{suffix}.png"), imgs[..., :3], nrow=nrow)
        if imgs.shape[-1] == 4:
            save_image_grid(os.path.join(d, f"depth_{suffix}.png"), imgs[..., 3:], nrow=nrow)

    # ---- the loop ----

    def run(self):
        if self.step == 0 and self.sample_at_init:
            self.sample(suffix="init")
        log = []
        elapsed = 0.0
        with open(os.path.join(self.output_dir, "log.txt"), "a") as log_file:
            while self.step < self.max_steps:
                t0 = time.time()
                metrics = self.run_step()
                self.step += 1
                report = self.step % self.i_log == 0 or (
                    self.i_print and self.step % self.i_print == 0)
                values = {k: float(v) for k, v in metrics.items()} if report else None
                dt = time.time() - t0
                elapsed += dt
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
                    self.save()
                if self.step % self.i_sample == 0:
                    self.sample()

    def _print_banner(self):
        print("\nTrainer initialized.")
        print(f"  - Backbone: {self.model.__class__.__name__}")
        print(f"  - Framework: {self.framework.__class__.__name__}")
        print(f"  - Dataset: {self.dataset.__class__.__name__}")
        print(f"  - Device: {self.device}")
        print(f"  - Batch size: {self.batch_size}")
        print(f"  - Batch split: {self.batch_split}")
        print(f"  - LR / WD: {self.learning_rate} / {self.weight_decay}")
        print(f"  - EMA rates: {self.ema_rate}")


class FinetuneMixin:
    """Start from a checkpoint whose first convolution may have fewer input
    channels, zero-padded to the model's."""

    def finetune_from(self, finetune_ckpt: str):
        state = ckpt_io.finetune_load(finetune_ckpt, self.model.state_dict())
        self.model.load_state_dict(state)
        with torch.no_grad():
            for ema in self.ema_params:
                for k, v in ema.items():
                    v.copy_(self.params[k])
        print(f"Finetuning from {finetune_ckpt}")


class InpaintTrainer(FinetuneMixin, BasicTrainer):
    """Conditional-completion trainer with warp conditioning synthesized on
    the device in every step."""

    def __init__(self, framework, dataset, output_dir, *, finetune_ckpt=None, **kwargs):
        self.augments = tuple(getattr(dataset, "augments", ()))
        self.pose_std = float(getattr(dataset, "std", 0.15))
        self.near = float(getattr(dataset, "near", 0.5))
        self.far = float(getattr(dataset, "far", 100.0))
        super().__init__(framework, dataset, output_dir, **kwargs)
        if finetune_ckpt:
            self.finetune_from(finetune_ckpt)

    def prepare_batch(self, batch, rng):
        return self.synthesize_cond(batch, rng)

    def synthesize_cond(self, batch, rng):
        """Random orbit pose, forward-backward warp and augments per sample
        (one noise source each, ``rng.split(B)``); adds ``y``, ``mask``,
        ``mask_rgb`` (with erode_rgb) and ``pose`` to the batch."""
        x01 = batch["x_0"] * 0.5 + 0.5  # datasets normalize to [-1, 1]
        warped = warp_cond.synthesize_batch(
            x01, rng.split(x01.shape[0]), augments=self.augments, pose_std=self.pose_std,
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
    ``y`` that the framework (``SuperResCFG``) packs."""

    def __init__(self, framework, dataset, output_dir, *, finetune_ckpt=None, **kwargs):
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
