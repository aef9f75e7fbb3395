"""ADE20K mask-to-image dataset (reference data/ade20k_dataset.py); the
port's copy of cocosnet_tpu/data/ade20k.py."""

from __future__ import annotations

import os
from typing import List, Tuple

from cocosnet_tpu_torch.config import Options
from cocosnet_tpu_torch.data.image_folder import make_dataset
from cocosnet_tpu_torch.data.pix2pix_dataset import (Pix2pixDataset, load_ref_table,
                                               ref_table_path)


class ADE20KDataset(Pix2pixDataset):
    def get_paths(self, opt: Options) -> Tuple[List[str], List[str]]:
        # ade20k_dataset.py:27-43: .jpg images + .png masks under
        # training/ (train) or validation/ (test)
        root = opt.dataroot
        phase = "val" if opt.phase == "test" else "train"
        subfolder = "validation" if opt.phase == "test" else "training"
        all_images = sorted(make_dataset(os.path.join(root, subfolder),
                                         read_cache=opt.phase != "test"))
        image_paths, label_paths = [], []
        for p in all_images:
            if f"_{phase}_" not in p:
                continue
            if p.endswith(".jpg"):
                image_paths.append(p)
            elif p.endswith(".png"):
                label_paths.append(p)
        return label_paths, image_paths

    def get_ref(self, opt: Options):
        extra = "_test" if opt.phase == "test" else ""
        table = ref_table_path(opt, f"ade20k_ref{extra}.txt")
        return (load_ref_table(table, opt.phase == "test"),
                ("training", "validation"))
