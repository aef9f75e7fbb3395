"""Visualization and image-saving utilities (reference util/util.py); the
port's copy of cocosnet_tpu/utils/visuals.py.

- tensor2im / tensor2label: [-1,1] NHWC arrays -> uint8 images
  (util.py:88-149)
- masktorgb: ADE20k label colorization via the color150 colormap
  (util.py:22-29). The .mat colormap is loaded from the repository's
  assets/color150.mat when present; otherwise the standard pascal-style
  bit colormap stands in, as in the JAX package.
- labelcolormap / Colorize: pascal bit-twiddled colormap (util.py:263-318)
- tile_images + save_image grid: the test.py comparison grid writer
  (reference test.py:51-69 uses torchvision.utils.save_image with
  nrow=batch, padding=0 — reproduced with numpy + PIL).
"""

from __future__ import annotations

import os
import numpy as np
from PIL import Image

_COLOR150 = None


def _load_color150() -> np.ndarray:
    global _COLOR150
    if _COLOR150 is not None:
        return _COLOR150
    path = os.path.join(os.path.dirname(__file__), "..", "..", "assets",
                        "color150.mat")
    if os.path.isfile(path):
        import scipy.io as scio
        _COLOR150 = scio.loadmat(path)["colors"]
        return _COLOR150
    _COLOR150 = labelcolormap(151)[1:]  # deterministic fallback
    return _COLOR150


def masktorgb(labels: np.ndarray) -> np.ndarray:
    """(B,1,H,W) or (B,H,W) int labels (1-based ADE20k) -> (B,3,H,W) uint8
    (util.py:22-29), vectorized instead of the reference's pixel loop."""
    if labels.ndim == 4:
        labels = labels[:, 0]
    colormap = _load_color150()
    # reference indexes colormap[value - 1]
    idx = np.clip(labels.astype(np.int64) - 1, 0, len(colormap) - 1)
    rgb = colormap[idx]  # (B, H, W, 3)
    return np.transpose(rgb, (0, 3, 1, 2)).astype(np.uint8)


def labelcolormap(n: int) -> np.ndarray:
    """pascal-style bit colormap (util.py:263-294)."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        idx = i
        for j in range(8):
            r |= ((idx >> 0) & 1) << (7 - j)
            g |= ((idx >> 1) & 1) << (7 - j)
            b |= ((idx >> 2) & 1) << (7 - j)
            idx >>= 3
        cmap[i] = [r, g, b]
    return cmap


def tensor2im(arr: np.ndarray, normalize: bool = True) -> np.ndarray:
    """NHWC [-1,1] float -> NHWC uint8 (util.py:88-119)."""
    if normalize:
        arr = (arr + 1.0) / 2.0 * 255.0
    else:
        arr = arr * 255.0
    return np.clip(arr, 0, 255).astype(np.uint8)


def tensor2label(label: np.ndarray, n_label: int) -> np.ndarray:
    """One-hot or index NHWC label -> colorized uint8 (util.py:123-149)."""
    if label.ndim == 4 and label.shape[-1] > 1:
        label = np.argmax(label, axis=-1)
    elif label.ndim == 4:
        label = label[..., 0]
    cmap = labelcolormap(n_label)
    return cmap[np.clip(label.astype(np.int64), 0, n_label - 1)]


def tile_images(imgs: np.ndarray, per_row: int = 4) -> np.ndarray:
    """util.py:64-83."""
    if imgs.shape[0] % per_row != 0:
        pad = per_row - imgs.shape[0] % per_row
        imgs = np.concatenate(
            [imgs, np.zeros((pad, *imgs.shape[1:]), imgs.dtype)], axis=0)
    rows = [np.concatenate(list(imgs[i: i + per_row]), axis=1)
            for i in range(0, imgs.shape[0], per_row)]
    return np.concatenate(rows, axis=0)


def save_image_grid(images: np.ndarray, path: str, nrow: int) -> None:
    """torchvision.utils.save_image(nrow=nrow, padding=0) equivalent for a
    (N,H,W,3) float array in [0,1]."""
    arr = np.clip(images * 255.0 + 0.5, 0, 255).astype(np.uint8)
    grid = tile_images(arr, per_row=nrow)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(grid).save(path)


def save_image(image: np.ndarray, path: str) -> None:
    """(H,W,3) float in [0,1] -> PNG."""
    arr = np.clip(image * 255.0 + 0.5, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)
