"""Base exemplar-paired dataset (reference data/pix2pix_dataset.py), the
port's copy of cocosnet_tpu/data/pix2pix_dataset.py for the datasets it
runs (ade20k, flickr; not DeepFashion's path layout and video pairs).

Numpy/PIL only: the loader makes the tensors. Each item is a dict of HWC
float32 arrays: {label, image, path, self_ref, ref, label_ref}; the
self-supervised pairing (exemplar == the image itself with probability
1 - real_reference_probability at train time) mirrors
pix2pix_dataset.py:67-149, with the same draws from the seeded generator.
"""

from __future__ import annotations

import os
import random
import re
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image

from cocosnet_tpu_torch.config import Options
from cocosnet_tpu_torch.data import transforms as T


def natural_sort(items: List[str]) -> None:
    """In-place natural sort (reference util/util.py natural_sort)."""
    def key(s):
        return [int(t) if t.isdigit() else t.lower()
                for t in re.split(r"(\d+)", s)]
    items.sort(key=key)


def ref_table_path(opt: Options, filename: str) -> str:
    """Locate a retrieval-pair table: --ref_table_dir first, then the
    dataroot's parent (lets tests point at bundled tables)."""
    for base in (opt.ref_table_dir, os.path.join(opt.dataroot, ".."),
                 opt.dataroot, "./data"):
        p = os.path.join(base, filename)
        if os.path.isfile(p):
            return p
    raise FileNotFoundError(
        f"retrieval table {filename} not found; searched {opt.ref_table_dir}, "
        f"{opt.dataroot}. Set --ref_table_dir.")


def load_ref_table(path: str, test_phase: bool) -> Dict[str, List[str]]:
    """CSV rows key,easy,...,hard -> {key: [easy, hard]} (train) or the full
    candidate list (test) — e.g. ade20k_dataset.py:45-59."""
    ref_dict: Dict[str, List[str]] = {}
    with open(path) as fd:
        for line in fd:
            items = line.strip().split(",")
            if not items or not items[0]:
                continue
            ref_dict[items[0]] = items[1:] if test_phase else [items[1], items[-1]]
    return ref_dict


class Pix2pixDataset:
    def __init__(self, opt: Options):
        self.opt = opt
        self.rng = random.Random(opt.seed)
        label_paths, image_paths = self.get_paths(opt)
        natural_sort(label_paths)
        natural_sort(image_paths)
        label_paths = label_paths[: opt.max_dataset_size]
        image_paths = image_paths[: opt.max_dataset_size]
        if not opt.no_pairing_check:
            for p1, p2 in zip(label_paths, image_paths):
                if not self.paths_match(p1, p2):
                    raise ValueError(
                        f"label-image pair ({p1}, {p2}) does not look "
                        "right; use --no_pairing_check to bypass")
        self.label_paths = label_paths
        self.image_paths = image_paths
        self.dataset_size = len(label_paths)
        self.real_reference_probability = (
            1.0 if opt.phase == "test" else opt.real_reference_probability)
        self.hard_reference_probability = (
            0.0 if opt.phase == "test" else opt.hard_reference_probability)
        self.ref_dict, self.train_test_folder = self.get_ref(opt)

    # ------------------------------------------------ subclass interface

    def get_paths(self, opt: Options) -> Tuple[List[str], List[str]]:
        raise NotImplementedError(
            "A subclass of Pix2pixDataset must override get_paths")

    def get_ref(self, opt: Options):
        raise NotImplementedError

    def imgpath_to_labelpath(self, path: str) -> str:
        return path

    def paths_match(self, p1: str, p2: str) -> bool:
        return (os.path.splitext(os.path.basename(p1))[0]
                == os.path.splitext(os.path.basename(p2))[0])

    def label_params(self, path: str) -> Dict:
        """The transform params of the label map at `path`: its crop and
        flip, drawn from the seeded generator (only its header is read)."""
        with Image.open(path) as label:
            return T.get_params(self.opt, label.size, self.rng)

    def get_label_tensor(self, path: str, params: Dict) -> np.ndarray:
        """HWC float32 label array (pix2pix_dataset.py:59-65)."""
        label = Image.open(path)
        arr = T.image_to_tensor(self.opt, label, params, method=T.NEAREST,
                                normalize=False) * 255.0
        arr[arr == 255] = self.opt.label_nc  # 'unknown' -> label_nc
        return arr

    # ------------------------------------------------------------- items

    def __len__(self) -> int:
        return self.dataset_size

    def draw(self, index: int) -> Dict:
        """Every draw item `index` makes from the seeded generator, in the
        order the JAX package's __getitem__ makes them: the label's crop
        and flip, the pairing coin, the exemplar label's crop and flip.
        The loader calls it on one thread in index order, so the items do
        not depend on how its threads run."""
        opt = self.opt
        image_path = self.image_paths[index]
        params1 = self.label_params(self.label_paths[index])
        random_p = self.rng.random()
        if random_p < self.real_reference_probability or opt.phase == "test":
            val = self.ref_dict[os.path.basename(image_path)]
            path_ref = val[1] if random_p < self.hard_reference_probability \
                else val[0]
            path_ref = (os.path.dirname(image_path).replace(
                self.train_test_folder[1], self.train_test_folder[0])
                + "/" + path_ref)
            path_ref_label = self.imgpath_to_labelpath(
                path_ref.replace(".jpg", ".png"))
        else:
            path_ref = path_ref_label = None
        params = self.label_params(path_ref_label or self.label_paths[index])
        return {"params1": params1, "path_ref": path_ref,
                "path_ref_label": path_ref_label, "params": params}

    def load(self, index: int, draws: Dict) -> Dict[str, np.ndarray]:
        """Item `index` from its draws: decodes and transforms, no draw."""
        opt = self.opt
        label_path = self.label_paths[index]
        label = self.get_label_tensor(label_path, draws["params1"])
        image_path = self.image_paths[index]
        image = Image.open(image_path).convert("RGB")
        image_arr = T.image_to_tensor(opt, image, draws["params1"])

        params = draws["params"]
        if draws["path_ref"] is not None:
            image_ref = Image.open(draws["path_ref"]).convert("RGB")
            label_ref = self.get_label_tensor(draws["path_ref_label"], params)
            ref_arr = T.image_to_tensor(opt, image_ref, params)
            self_ref = np.float32(0.0)
        else:
            label_ref = self.get_label_tensor(label_path, params)
            ref_arr = T.image_to_tensor(opt, image, params)
            self_ref = np.float32(1.0)

        return {
            "label": label,
            "image": image_arr,
            "path": image_path,
            "self_ref": self_ref,
            "ref": ref_arr,
            "label_ref": label_ref,
        }

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.load(index, self.draw(index))
