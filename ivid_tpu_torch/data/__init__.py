"""Datasets and the data loader. The procedural datasets are ported
(``SyntheticRGBD`` and its warp and super-resolution forms); the file-backed
ones (ImageNet, SingleCategory and their SR/Warp forms) read image files
through PIL and wait for a later slice."""

from ivid_tpu_torch.data.base import (
    BaseDataset,
    SyntheticRGBD,
    SyntheticRGBDSR,
    SyntheticRGBDWarp,
    WarpDataset,
)
from ivid_tpu_torch.data.collect import collect_data
from ivid_tpu_torch.data.loader import DataLoader

DATASETS = {
    "SyntheticRGBD": SyntheticRGBD,
    "SyntheticRGBDWarp": SyntheticRGBDWarp,
    "SyntheticRGBDSR": SyntheticRGBDSR,
}


def build_dataset(section: dict, data_dir: str):
    """The dataset of a config's ``dataset`` section, rooted at ``data_dir``."""
    name = section["name"]
    if name not in DATASETS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet; the port has {sorted(DATASETS)}"
        )
    return DATASETS[name](data_dir, **section.get("args", {}))


__all__ = ["DATASETS", "BaseDataset", "DataLoader", "SyntheticRGBD", "SyntheticRGBDSR",
           "SyntheticRGBDWarp", "WarpDataset", "build_dataset", "collect_data"]
