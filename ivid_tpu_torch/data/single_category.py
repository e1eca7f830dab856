"""Single-category RGBD dataset: unlabelled ``images/*.*`` beside
``depths/{stem}.npz``.

Port of ``ivid_tpu/data/single_category.py``: the images in sorted order, the
listing cached in ``{root}/dataset.json`` in the JAX package's format (either
package reads the other's). PNG folders need no image library.
"""

from __future__ import annotations

import glob
import json
import os

from ivid_tpu_torch.data.base import BaseDataset, SRDataset, WarpDataset


class SingleCategory(BaseDataset):
    def get_fileinfo(self):
        cache = os.path.join(self.root_path, "dataset.json")
        if os.path.isfile(cache):
            with open(cache) as f:
                info = json.load(f)
            self.images, self.depths = info["images"], info["depths"]
            return
        self.images = sorted(os.path.relpath(p, self.root_path)
                             for p in glob.glob(os.path.join(self.root_path, "images", "*.*")))
        if not self.images:
            raise FileNotFoundError(f"no images under {self.root_path}/images")
        self.depths = [os.path.join("depths", os.path.basename(f).rsplit(".", 1)[0] + ".npz")
                       for f in self.images]
        with open(cache, "w") as f:
            json.dump({"images": self.images, "depths": self.depths}, f)


class SingleCategorySR(SRDataset, SingleCategory):
    pass


class SingleCategoryWarp(WarpDataset, SingleCategory):
    pass
