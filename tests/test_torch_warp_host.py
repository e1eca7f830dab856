"""The port's HostWarpDataset (warp conditioning in loader workers, on the
CPU) vs the JAX package's, and the inpaint trainer with ``warp_host``.

Tolerances as ``test_torch_warp.py``'s for ``synthesize_single``: the pose
within 1e-6; at most 1% of mask pixels differ (a pixel centre on an edge);
``y`` within 1e-5 where both masks are set.
"""

import pickle
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from ivid_tpu.data import SyntheticRGBDWarp as JSyntheticRGBDWarp
from ivid_tpu.data.warp_host import HostWarpDataset as JHostWarpDataset
from ivid_tpu_torch.data import DataLoader, HostWarpDataset, SyntheticRGBDWarp
from ivid_tpu_torch.diffusion.frameworks import build_framework
from ivid_tpu_torch.models import adm
from ivid_tpu_torch.training.trainer import InpaintTrainer, StepRecord

from test_torch_diffusion import JaxReplayNoise

torch.set_num_threads(2)
MASK_FRAC, VALUE_TOL = 1e-2, 1e-5
AUGMENTS = ("prewarp_noise", "postwarp_noise", "blur", "erode_rgb")
KEYS = ["mask", "mask_rgb", "pose", "x_0", "y"]


def _data(cls, s=16, length=8):
    return cls(image_size=s, length=length, augments=AUGMENTS, std=0.15, normalize=True,
               normalize_depth=True, prepocess_depth="z_buffer")


def _wrap(cls, ds, seed=0):
    return cls(ds, augments=ds.augments, pose_std=ds.std, near=ds.near, far=ds.far, seed=seed)


@pytest.mark.parametrize("index,seed", [(0, 3), (1, 4)])
def test_get_with_rng_matches_jax(index, seed):
    key = jax.random.PRNGKey(seed)
    want = _wrap(JHostWarpDataset, _data(JSyntheticRGBDWarp)).get_with_rng(index, key)
    got = _wrap(HostWarpDataset, _data(SyntheticRGBDWarp)).get_with_rng(
        index, JaxReplayNoise(key))
    assert sorted(got) == sorted(want) == KEYS
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got["x_0"], want["x_0"])
    np.testing.assert_allclose(got["pose"], want["pose"], atol=1e-6, rtol=0)
    m_w, m_g = want["mask"] > 0.5, got["mask"] > 0.5
    assert m_w.mean() > 0.1 and (m_w != m_g).mean() <= MASK_FRAC
    both = (m_w & m_g)[..., 0]
    np.testing.assert_allclose(got["y"][both], want["y"][both], atol=VALUE_TOL, rtol=0)


def test_items_follow_seed_index_and_visit_and_pickle():
    ds = _wrap(HostWarpDataset, _data(SyntheticRGBDWarp), seed=7)
    first, second = ds[3], ds[3]
    assert not np.array_equal(first["pose"], second["pose"])  # fresh augments per visit
    np.testing.assert_array_equal(first["x_0"], second["x_0"])
    copy = pickle.loads(pickle.dumps(ds))
    assert copy._visits == {} and ds._visits == {3: 2}
    again = copy[3]  # a new process starts its visits afresh
    for k in KEYS:
        np.testing.assert_array_equal(again[k], first[k])
    other = _wrap(HostWarpDataset, _data(SyntheticRGBDWarp), seed=8)[3]
    assert not np.array_equal(other["pose"], first["pose"])


def test_visit_counts_survive_many_threads():
    """More threads than cores load one index at once: no visit is lost."""
    ds = _wrap(HostWarpDataset, _data(SyntheticRGBDWarp, s=8))
    ds.get_with_rng = lambda index, rng: index  # the count alone, not the warp
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [ds[0] for _ in range(200)])
                   for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert ds._visits == {0: 32 * 200}


def test_process_workers_attach_the_conditioning():
    """Spawned workers hold a pickled copy and warp on the CPU."""
    ds = _wrap(HostWarpDataset, _data(SyntheticRGBDWarp), seed=2)
    loader = DataLoader(ds, 4, num_workers=2, worker_mode="process", prefetch=1, seed=1)
    it = iter(loader)
    try:
        batch = next(it)
    finally:
        it.close()
    assert sorted(batch) == KEYS and batch["y"].shape == (4, 16, 16, 4)
    first = loader._epoch_indices(0)[0]
    local = _wrap(HostWarpDataset, _data(SyntheticRGBDWarp), seed=2)
    for row, i in enumerate(first):
        np.testing.assert_array_equal(batch["pose"][row], local[int(i)]["pose"])


def test_inpaint_trainer_steps_with_warp_host(tmp_path):
    cfg = dict(image_size=16, in_channels=10, out_channels=4, model_channels=16,
               num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[8], num_groups=8,
               num_heads=None, num_head_channels=16, num_classes=None, has_null_class=False,
               dropout=0.0, use_fp16=False)
    fw = build_framework("InpaintCFG", adm.randomize_parameters(adm.build_adm_unet(cfg), 1),
                         {"timesteps": 100, "beta_schedule": "linear", "p_uncond": 0.1})
    tr = InpaintTrainer(fw, _data(SyntheticRGBDWarp), str(tmp_path), max_steps=1, batch_size=2,
                        i_log=1, i_sample=10 ** 9, i_save=10 ** 9, sample_at_init=False,
                        device="cpu", warp_host=True, num_workers=2)
    assert isinstance(tr._loader_obj.dataset, HostWarpDataset)
    batch = tr._device_batch(next(tr.loader))
    assert tr.prepare_batch(batch, None) is batch  # the loader attached the warp
    tr.record = StepRecord()
    tr.run()
    position = tr._loader_obj.position
    tr.close()  # stops the workers; the next step starts them at the cursor
    assert tr.step == 1 and np.isfinite(float(tr.record.losses[0]))
    tr.run_step()
    assert tr._loader_obj.position == (position[0], position[1] + 1)
    tr.close()
