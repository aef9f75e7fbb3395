"""Host-side preprocessing with PIL-exact semantics, the port's copy of
cocosnet_tpu/data/transforms.py.

The model math runs on the GPU, but decode/resize/crop/flip stay on the
host with the same PIL calls the reference uses (data/base_dataset.py:
25-137), so the inputs are bit for bit those of the reference and of the
JAX package.

Outputs are NHWC numpy float32; images normalized to [-1, 1]
(transforms.Normalize(0.5,0.5,0.5), base_dataset.py:81-82), labels scaled
x255 with 255 -> label_nc (pix2pix_dataset.py:63-64) by the dataset classes.
"""

from __future__ import annotations

import random
from typing import Dict, Tuple

import numpy as np
from PIL import Image

from cocosnet_tpu_torch.config import Options

BICUBIC = Image.BICUBIC
BILINEAR = Image.BILINEAR
NEAREST = Image.NEAREST


def get_params(opt: Options, size: Tuple[int, int],
               rng: random.Random) -> Dict:
    """base_dataset.py:25-44 — random crop position + coin-flip flip."""
    w, h = size
    new_h, new_w = h, w
    if opt.preprocess_mode == "resize_and_crop":
        new_h = new_w = opt.load_size
    elif opt.preprocess_mode == "scale_width_and_crop":
        new_w = opt.load_size
        new_h = opt.load_size * h // w
    elif opt.preprocess_mode == "scale_shortside_and_crop":
        ss, ls = min(w, h), max(w, h)
        width_is_shorter = w == ss
        ls = int(opt.load_size * ls / ss)
        new_w, new_h = (ss, ls) if width_is_shorter else (ls, ss)
    x = rng.randint(0, max(0, new_w - opt.crop_size))
    y = rng.randint(0, max(0, new_h - opt.crop_size))
    flip = rng.random() > 0.5
    return {"crop_pos": (x, y), "flip": flip}


def _scale_width(img: Image.Image, target_width: int, method) -> Image.Image:
    ow, oh = img.size
    if ow == target_width:
        return img
    return img.resize((target_width, int(target_width * oh / ow)), method)


def _scale_shortside(img: Image.Image, target: int, method) -> Image.Image:
    ow, oh = img.size
    ss, ls = min(ow, oh), max(ow, oh)
    width_is_shorter = ow == ss
    if ss == target:
        return img
    ls = int(target * ls / ss)
    nw, nh = (ss, ls) if width_is_shorter else (ls, ss)
    return img.resize((nw, nh), method)


def _make_power_2(img: Image.Image, base: int, method) -> Image.Image:
    ow, oh = img.size
    h, w = int(round(oh / base) * base), int(round(ow / base) * base)
    if (h, w) == (oh, ow):
        return img
    return img.resize((w, h), method)


def apply_transform(opt: Options, img: Image.Image, params: Dict,
                    method=BICUBIC, is_flickr_label: bool = False) -> Image.Image:
    """get_transform minus tensor conversion (base_dataset.py:47-83)."""
    if is_flickr_label:
        img = Image.fromarray(np.array(img) + 1)  # base_dataset.py:49-50
    mode = opt.preprocess_mode
    if "resize" in mode:
        img = img.resize((opt.load_size, opt.load_size), method)
    elif "scale_width" in mode:
        img = _scale_width(img, opt.load_size, method)
    elif "scale_shortside" in mode:
        img = _scale_shortside(img, opt.load_size, method)
    if "crop" in mode:
        x, y = params["crop_pos"]
        img = img.crop((x, y, x + opt.crop_size, y + opt.crop_size))
    if mode == "none":
        img = _make_power_2(img, 32, method)
    if mode == "fixed":
        w = opt.crop_size
        h = round(opt.crop_size / opt.aspect_ratio)
        img = img.resize((w, h), method)
    if opt.isTrain and not opt.no_flip and params.get("flip"):
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


def to_float_chw_free(img: Image.Image) -> np.ndarray:
    """torchvision ToTensor equivalent, but HWC: uint8 -> [0,1] float32."""
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr / 255.0


def image_to_tensor(opt: Options, img: Image.Image, params: Dict,
                    method=BICUBIC, normalize: bool = True,
                    is_flickr_label: bool = False) -> np.ndarray:
    """transform + ToTensor + Normalize(±1), HWC float32."""
    img = apply_transform(opt, img, params, method, is_flickr_label)
    arr = to_float_chw_free(img)
    if normalize:
        arr = (arr - 0.5) / 0.5
    return arr
