"""ImageNet RGBD dataset: ``images/{wnid}/*.JPEG`` beside
``depths/{wnid}/*.npz``.

Port of ``ivid_tpu/data/imagenet.py``: the labels are the sorted folder
names, the files of a label come in ``glob`` order, and the listing is
cached in ``{root}/dataset.json`` in the JAX package's format (either
package reads the other's). The JPEGs are read through PIL.
"""

from __future__ import annotations

import glob
import json
import os

from ivid_tpu_torch.data.base import BaseDataset, SRDataset, WarpDataset


class ImageNet(BaseDataset):
    def get_fileinfo(self):
        cache = os.path.join(self.root_path, "dataset.json")
        if os.path.isfile(cache):
            with open(cache) as f:
                info = json.load(f)
            self.labels, self.images, self.depths = info["labels"], info["images"], info["depths"]
            return
        labels = sorted(os.listdir(os.path.join(self.root_path, "images")))
        if not labels:
            raise FileNotFoundError(f"no label folders under {self.root_path}/images")
        self.images, self.depths = [], []
        for label in labels:
            found = [os.path.relpath(p, self.root_path)
                     for p in glob.glob(os.path.join(self.root_path, "images", label, "*.JPEG"))]
            self.images += found
            self.depths += [os.path.join("depths", label, os.path.basename(f).replace("JPEG", "npz"))
                            for f in found]
        self.labels = {c: i for i, c in enumerate(labels)}
        with open(cache, "w") as f:
            json.dump({"labels": self.labels, "images": self.images, "depths": self.depths}, f)


class ImageNetSR(SRDataset, ImageNet):
    pass


class ImageNetWarp(WarpDataset, ImageNet):
    pass
