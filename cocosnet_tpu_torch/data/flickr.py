"""Flickr landscape mask-to-image dataset (reference data/flickr_dataset.py);
the port's copy of cocosnet_tpu/data/flickr.py.

Labels get the +1 value shift applied in the transform path
(base_dataset.py:49-50) because the Flickr masks are 0-based.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image

from cocosnet_tpu_torch.config import Options
from cocosnet_tpu_torch.data import transforms as T
from cocosnet_tpu_torch.data.pix2pix_dataset import (Pix2pixDataset, load_ref_table,
                                               ref_table_path)


class FlickrDataset(Pix2pixDataset):
    def get_paths(self, opt: Options) -> Tuple[List[str], List[str]]:
        root = (os.path.join(opt.dataroot, "test/images")
                if opt.phase == "test"
                else os.path.join(opt.dataroot, "images"))
        root_mask = root.replace("images", "mask")
        image_paths = [os.path.join(root, it)
                       for it in sorted(os.listdir(root))]
        label_paths = [os.path.join(root_mask, it)
                       for it in sorted(os.listdir(root_mask))]
        return label_paths, image_paths

    def get_ref(self, opt: Options):
        extra = "_test_from_train" if opt.phase == "test" else ""
        table = ref_table_path(opt, f"flickr_ref{extra}.txt")
        return load_ref_table(table, opt.phase == "test"), ("", "test")

    def get_label_tensor(self, path: str, params: Dict) -> np.ndarray:
        label = Image.open(path)
        arr = T.image_to_tensor(self.opt, label, params, method=T.NEAREST,
                                normalize=False, is_flickr_label=True) * 255.0
        arr[arr == 255] = self.opt.label_nc
        return arr

    def imgpath_to_labelpath(self, path: str) -> str:
        return path.replace("images", "mask")
