"""Recursive image-file discovery (reference data/image_folder.py:30-58);
the port's copy of cocosnet_tpu/data/image_folder.py."""

from __future__ import annotations

import os
from typing import List

IMG_EXTENSIONS = (".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG",
                  ".ppm", ".PPM", ".bmp", ".BMP", ".tiff", ".webp")


def is_image_file(filename: str) -> bool:
    return filename.endswith(IMG_EXTENSIONS)


def make_dataset(dir: str, read_cache: bool = False) -> List[str]:
    """Every image file under dir, recursively, in sorted walk order; with
    read_cache, the list in dir/files.list when there is one."""
    if read_cache:
        possible_filelist = os.path.join(dir, "files.list")
        if os.path.isfile(possible_filelist):
            with open(possible_filelist) as f:
                return f.read().splitlines()
    images: List[str] = []
    for root, _, fnames in sorted(os.walk(dir, followlinks=True)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
    return images
