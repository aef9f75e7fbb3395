"""A synthetic ADE20k tree, made from a seed, for running the entry points
where the real dataset is absent (nothing is downloaded):

    root/training/ADE_train_<i>.jpg + .png   photos and label maps
    root/validation/ADE_val_<i>.jpg + .png
    root/ade20k_ref.txt       train retrieval table: key,easy,hard
    root/ade20k_ref_test.txt  test table: val key,training candidates...

The label maps are blocks of one class each, drawn from 0..n_classes-1
(0 is ADE20k's "unlabelled"); the photos are smooth colour fields with
noise, coloured per class so that they match their labels. The default
size, 384 x 288, is not the crop, so the resize and the random crop run.
The root must not contain "validation": the dataset finds an exemplar's
folder by replacing that word in the image's path.

    python -m cocosnet_tpu_torch.data.synthetic ROOT [--train 24] [--val 12]

writes the tree at ADE20k's 151 classes from seed 0.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np
from PIL import Image


def _pair(rs: np.random.RandomState, size: Tuple[int, int], n_classes: int,
          palette: np.ndarray, block: int):
    w, h = size
    gh, gw = -(-h // block), -(-w // block)
    classes = rs.randint(0, n_classes, (gh, gw))
    label = np.kron(classes, np.ones((block, block), np.int64))[:h, :w]
    photo = palette[label] + rs.randn(h, w, 3) * 12.0
    return (Image.fromarray(np.clip(photo, 0, 255).astype(np.uint8)),
            Image.fromarray(label.astype(np.uint8)))


def make_ade20k_tree(root: str, n_train: int = 24, n_val: int = 12,
                     size: Tuple[int, int] = (384, 288),
                     n_classes: int = 151, seed: int = 0,
                     block: int = 32) -> Tuple[List[str], List[str]]:
    """Writes the tree under root (see the module docstring) and returns
    the training and validation image names. size is (width, height)."""
    if "validation" in os.path.abspath(root):
        raise ValueError(f"{root}: the root must not contain 'validation'")
    rs = np.random.RandomState(seed)
    palette = rs.randint(30, 226, (n_classes, 3)).astype(np.float64)
    names = {}
    for split, phase, n in (("training", "train", n_train),
                            ("validation", "val", n_val)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        names[split] = [f"ADE_{phase}_{i:08d}.jpg" for i in range(1, n + 1)]
        for name in names[split]:
            photo, label = _pair(rs, size, n_classes, palette, block)
            photo.save(os.path.join(root, split, name), quality=95)
            label.save(os.path.join(root, split,
                                    name.replace(".jpg", ".png")))
    train, val = names["training"], names["validation"]
    with open(os.path.join(root, "ade20k_ref.txt"), "w") as f:
        for i, n in enumerate(train):
            f.write(f"{n},{train[(i + 1) % len(train)]},"
                    f"{train[(i + 2) % len(train)]}\n")
    with open(os.path.join(root, "ade20k_ref_test.txt"), "w") as f:
        for i, n in enumerate(val):
            f.write(f"{n},{train[i % len(train)]},"
                    f"{train[(i + 1) % len(train)]}\n")
    return train, val


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--train", type=int, default=24)
    ap.add_argument("--val", type=int, default=12)
    args = ap.parse_args(argv)
    make_ade20k_tree(args.root, args.train, args.val)
    print(f"wrote a synthetic ADE20k tree under {args.root}")


if __name__ == "__main__":
    main()
