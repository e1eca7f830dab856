"""Port datasets, loader and checkpoint files vs the JAX package (CPU). All
exact: the items and the per-epoch permutations are the same numpy code."""

import os

import numpy as np
import pytest
import torch

from ivid_tpu.data import DataLoader as JDataLoader
from ivid_tpu.data import SyntheticRGBD as JSyntheticRGBD
from ivid_tpu.data import SyntheticRGBDWarp as JSyntheticRGBDWarp
from ivid_tpu.training import checkpoint as jckpt
from ivid_tpu_torch.data import DATASETS, DataLoader, SyntheticRGBD, SyntheticRGBDWarp, build_dataset
from ivid_tpu_torch.training import checkpoint as tckpt

ARGS = dict(image_size=16, length=10, normalize=True, normalize_depth=True,
            prepocess_depth="z_buffer", near=0.5, far=100)


@pytest.mark.parametrize("num_classes", [None, 3])
def test_synthetic_items_match_jax(num_classes):
    got, want = SyntheticRGBD(**ARGS, num_classes=num_classes), JSyntheticRGBD(
        **ARGS, num_classes=num_classes)
    assert len(got) == len(want) and got.num_classes == want.num_classes
    for i in (0, 7):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


def test_warp_dataset_fields_match_jax():
    kw = dict(ARGS, augments=["blur", "erode_rgb"], std=0.2)
    got, want = SyntheticRGBDWarp(**kw), JSyntheticRGBDWarp(**kw)
    for f in ("augments", "std", "near", "far", "image_size", "normalize", "normalize_depth"):
        assert getattr(got, f) == getattr(want, f), f


def test_loader_and_resume_match_jax():
    ds = SyntheticRGBD(**ARGS, num_classes=3)
    want_loader = JDataLoader(JSyntheticRGBD(**ARGS, num_classes=3), 3, num_workers=1, seed=4)
    loader = DataLoader(ds, 3, seed=4)
    got_it, want_it = iter(loader), iter(want_loader)
    for _ in range(7):  # across two epoch boundaries (3 full batches per epoch)
        a, b = next(got_it), next(want_it)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
        assert loader.position == want_loader.position
    resumed = iter(DataLoader(ds, 3, seed=4, start=loader.position))
    for _ in range(2):
        np.testing.assert_array_equal(next(resumed)["x_0"], next(got_it)["x_0"])


def test_registry_names_unported_datasets():
    """Every dataset of the JAX package is ported; another name raises."""
    from ivid_tpu.data import DATASETS as JDATASETS

    assert sorted(DATASETS) == sorted(JDATASETS)
    ds = build_dataset({"name": "SyntheticRGBDWarp", "args": dict(ARGS, augments=["blur"])}, "")
    assert ds.augments == ["blur"] and len(ds) == 10
    with pytest.raises(NotImplementedError, match="LSUNWarp"):
        build_dataset({"name": "LSUNWarp", "args": {}}, "data")


def test_checkpoint_files(tmp_path):
    out = str(tmp_path)
    for step in (3, 12):
        assert os.path.basename(tckpt.model_path(out, step)) == os.path.basename(
            jckpt.model_path(out, step)).replace(".msgpack", ".pt")
        assert os.path.basename(tckpt.ema_path(out, 0.9999, step)) == os.path.basename(
            jckpt.ema_path(out, 0.9999, step)).replace(".msgpack", ".pt")
        assert os.path.basename(tckpt.misc_path(out, step)) == os.path.basename(
            jckpt.misc_path(out, step)).replace(".msgpack", ".pt")
    assert tckpt.find_latest_step(out) is None
    tckpt.save(tckpt.model_path(out, 3), {"w": torch.ones(2)})
    tckpt.save(tckpt.ema_path(out, 0.9999, 12), {"w": torch.ones(2)})  # no model file: incomplete
    assert tckpt.find_latest_step(out) == 3
    assert torch.equal(tckpt.load(tckpt.model_path(out, 3))["w"], torch.ones(2))
    assert not [n for n in os.listdir(os.path.join(out, "ckpts")) if n.endswith(".tmp")]
