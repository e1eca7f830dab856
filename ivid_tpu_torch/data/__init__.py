"""Datasets and the data loader: the file-backed RGBD datasets (ImageNet,
SingleCategory and their SR/Warp forms), the procedural ``SyntheticRGBD``
family, the worker loader and the host-side warp wrapper."""

from ivid_tpu_torch.data.base import (
    BaseDataset,
    SRDataset,
    SyntheticRGBD,
    SyntheticRGBDSR,
    SyntheticRGBDWarp,
    WarpDataset,
)
from ivid_tpu_torch.data.collect import collect_data
from ivid_tpu_torch.data.imagenet import ImageNet, ImageNetSR, ImageNetWarp
from ivid_tpu_torch.data.loader import DataLoader
from ivid_tpu_torch.data.single_category import (
    SingleCategory,
    SingleCategorySR,
    SingleCategoryWarp,
)
from ivid_tpu_torch.data.warp_host import HostWarpDataset

DATASETS = {
    "ImageNet": ImageNet,
    "ImageNetSR": ImageNetSR,
    "ImageNetWarp": ImageNetWarp,
    "SingleCategory": SingleCategory,
    "SingleCategorySR": SingleCategorySR,
    "SingleCategoryWarp": SingleCategoryWarp,
    "SyntheticRGBD": SyntheticRGBD,
    "SyntheticRGBDSR": SyntheticRGBDSR,
    "SyntheticRGBDWarp": SyntheticRGBDWarp,
}


def build_dataset(section: dict, data_dir: str):
    """The dataset of a config's ``dataset`` section, rooted at ``data_dir``."""
    name = section["name"]
    if name not in DATASETS:
        raise NotImplementedError(f"unknown dataset {name!r}; the port has {sorted(DATASETS)}")
    return DATASETS[name](data_dir, **section.get("args", {}))


__all__ = ["DATASETS", "BaseDataset", "DataLoader", "HostWarpDataset", "SRDataset",
           "build_dataset", "collect_data", "WarpDataset", *DATASETS]
