"""Whole runs of each driver on the CPU at a tiny size (the program's plain
versions, the cell's own limits), with faults planted in the program under
the timed path, and with the control in the program's place: each must come
out not correct. The look for a card is skipped; the rest of a run is
driven as ``run.py`` drives it."""

from __future__ import annotations

import pytest
from conftest import CpuRun

from port_bench import faults, run

SAMPLE_CELLS = ("in128.sample.random_b8", "sc128.sample.random_b1")
TRAIN_CELL = "sc128.train.inpaint_b8"


def correct(r, out) -> bool:
    return run.judge(out["readings"], r.limits)[0] and out["failed"] == 0


def sample_run(workload):
    from port_bench.drivers import sample

    r = CpuRun(workload)
    return r, sample.run(r)


def train_run():
    from port_bench.drivers import train

    r = CpuRun(TRAIN_CELL)
    return r, train.run(r)


# ---- sampling ----

def last_step_unchanged(patch):
    """The sampler's last step returns its state unchanged."""
    from ivid_tpu_torch.diffusion import samplers

    original = samplers.ddim_sample

    def broken(*args, **kwargs):
        out = original(*args, **dict(kwargs, return_trajectory=True))
        traj = out["pred_x_t"]
        return {"samples": traj[-2] if len(traj) > 1 else out["samples"]}

    patch(samplers, "ddim_sample", broken)


def half_batch_left_out(patch):
    """Half of the batch is not computed: its rows repeat the other half's."""
    from ivid_tpu_torch.inference.pipeline import ScenePipeline

    original = ScenePipeline.sample_batch

    def broken(self, *args, **kwargs):
        state, samples, conds = original(self, *args, **kwargs)
        half = samples.shape[0] // 2
        samples = samples.clone()
        samples[half:2 * half] = samples[:half]
        return state, samples, conds

    patch(ScenePipeline, "sample_batch", broken)


def view_altered(patch):
    """One scene's completed view is altered where the guided sampler
    produces it (its channels in reverse order)."""
    from ivid_tpu_torch.inference.pipeline import ScenePipeline

    original = ScenePipeline._guided_ddim

    def broken(self, *args, **kwargs):
        x = original(self, *args, **kwargs).clone()
        x[0] = x[0].flip(-1)
        return x

    patch(ScenePipeline, "_guided_ddim", broken)


SAMPLE_FAULTS = {"last_step_unchanged": last_step_unchanged,
                 "half_batch_left_out": half_batch_left_out, "view_altered": view_altered,
                 **faults.SAMPLE_PROGRAM_FAULTS}


@pytest.mark.parametrize("workload", SAMPLE_CELLS)
def test_sample_intact_is_correct(workload):
    r, out = sample_run(workload)
    assert correct(r, out), out["readings"]


@pytest.mark.parametrize("workload", SAMPLE_CELLS)
@pytest.mark.parametrize("fault", sorted(SAMPLE_FAULTS))
def test_sample_fault_is_not_correct(workload, fault, monkeypatch):
    r = CpuRun(workload)
    if fault == "half_batch_left_out" and r.traffic["batch"] < 2:
        pytest.skip("a batch of one has no half to leave out")
    SAMPLE_FAULTS[fault](monkeypatch.setattr)
    r, out = sample_run(workload)
    assert not correct(r, out), out["readings"]


@pytest.mark.parametrize("workload", SAMPLE_CELLS)
def test_sample_control_is_not_correct(workload):
    """The reference one precision step below the configuration, in the
    program's place, fails the cell's limits."""
    from port_bench.drivers import sample

    r = CpuRun(workload)
    cfg, traffic = r.config, r.traffic
    ref = sample.Reference(cfg, r.device)
    ctl = sample.Reference(cfg, r.device, sample.control_precision(cfg))
    ref.load(cfg, r.seed)
    ctl.load(cfg, r.seed)
    out = sample.control_outputs(cfg, traffic, r.seed, ctl, 0)
    readings = sample.judge(cfg, traffic, r.seed, ref, out, 0)
    assert not run.judge(readings, r.limits)[0], readings


# ---- training ----

def optimizer_skipped(monkeypatch):
    """A step that returns the model's state unchanged."""
    from ivid_tpu_torch.training import trainer

    original = trainer.InpaintTrainer.__init__

    def broken(self, *args, **kwargs):
        original(self, *args, **kwargs)
        self.optimizer.step = lambda *a, **k: None

    monkeypatch.setattr(trainer.InpaintTrainer, "__init__", broken)


def loss_over_half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from ivid_tpu_torch.diffusion import frameworks

    original = frameworks.InpaintCFG.training_loss

    def broken(self, rng, batch):
        half = batch["x_0"].shape[0] // 2
        return original(self, rng, {k: v[:half] for k, v in batch.items()})

    monkeypatch.setattr(frameworks.InpaintCFG, "training_loss", broken)


def condition_altered(monkeypatch):
    """One row's condition altered where the warp produces it: the whole
    image given as seen, in white. (At 16x16 most of a warped image is
    unseen already, so blanking it would change little.)"""
    from ivid_tpu_torch.training import warp_cond

    original = warp_cond.synthesize_batch

    def broken(*args, **kwargs):
        out = dict(original(*args, **kwargs))
        for k in ("y", "mask", "mask_rgb"):
            if k in out:
                out[k] = out[k].clone()
                out[k][0] = 1.0
        return out

    monkeypatch.setattr(warp_cond, "synthesize_batch", broken)


def ema_skipped(monkeypatch):
    """The EMA of the parameters is never updated."""
    from ivid_tpu_torch.training import trainer

    monkeypatch.setattr(trainer.InpaintTrainer, "update_ema", lambda self: None)


TRAIN_FAULTS = {"optimizer_skipped": optimizer_skipped,
                "loss_over_half_batch": loss_over_half_batch,
                "condition_altered": condition_altered, "ema_skipped": ema_skipped}


@pytest.fixture(scope="module")
def train_intact():
    return train_run()[1]["readings"]


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_not_correct(fault, monkeypatch, train_intact):
    """The broken run fails the cell's limits, and by a number that reads
    well above the intact run's (at this tiny size the intact readings lie
    near the limits, so the fault, not the size, must be what fails)."""
    TRAIN_FAULTS[fault](monkeypatch)
    r, out = train_run()
    assert not correct(r, out), out["readings"]
    assert any(v > max(r.limits[k], 3 * train_intact[k]) for k, v in out["readings"].items()), \
        (out["readings"], train_intact)


def test_train_control_is_not_correct():
    from port_bench.drivers import train

    r = CpuRun(TRAIN_CELL)
    ref = train.reference_steps(r.config, r.traffic, r.seed, r.device)
    ctl = train.reference_steps(r.config, r.traffic, r.seed, r.device, precision="fp8")
    readings = train.readings(ctl, ref)
    assert not run.judge(readings, r.limits)[0], readings
    intact = train.readings(train.reference_steps(r.config, r.traffic, r.seed, r.device,
                                                  precision="bf16"), ref)
    assert readings["grad_gap"] > 3 * intact["grad_gap"], (readings, intact)

