"""Offline CelebA-HQ edge / distance-map builder (reference
util/mask_to_edge.py). Twin of tools/mask_to_edge.py, on the port's native
host library (data/native.py, built from cocosnet_tpu_torch/native/
host_ops.cc at its first use).

Precomputes, for every image id, the 15-channel stack that celebahqedge
otherwise builds per item at load time (celebahqedge_dataset.py:76-116,
data/celebahqedge.get_label_tensor, before its flip and crop): the edges
with the photo's Canny inside the face, the 13 parts' distance transforms
and the parts' boundary map, uint8, written as <id>_edges.npy. The work is
on the host; --platform is the port's entry-point flag, as on the other
twins (the card by default, raising without one; cpu).

    python -m cocosnet_tpu_torch.tools.mask_to_edge \\
        --dataroot <CelebAMask-HQ root> --out <dir> [--load_size 256] \\
        [--ids 0-29999] [--platform cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from cocosnet_tpu_torch.data import native as NAT

INNER_PARTS = ["skin", "l_brow", "r_brow", "l_eye", "r_eye", "l_ear", "r_ear",
               "nose", "u_lip", "mouth", "l_lip", "eye_g", "hair"]


def build_one(dataroot: str, idx: int, load_size: int) -> np.ndarray:
    name = str(idx).zfill(5)
    subfolder = str(idx // 2000)
    anno = os.path.join(dataroot, "CelebAMask-HQ-mask-anno", subfolder,
                        name + "_{}.png")
    img_path = os.path.join(dataroot, "CelebA-HQ-img", f"{idx}.jpg")
    img = Image.open(img_path).resize((load_size, load_size),
                                      resample=Image.BILINEAR)

    inner_label = np.ones((load_size, load_size), dtype=np.uint8)
    edges = np.zeros((load_size, load_size), dtype=np.uint8)
    dist_channels = []
    for part in INNER_PARTS:
        edge = np.zeros((load_size, load_size), dtype=np.uint8)
        p = anno.format(part)
        if os.path.exists(p):
            part_label = np.array(Image.open(p).convert("L").resize(
                (load_size, load_size), resample=Image.NEAREST))
            if part == "hair":
                inner_label[part_label == 255] = 1
            else:
                inner_label[part_label == 255] = 0
            edges = NAT.mask_edges(edges, part_label)
            edge = NAT.mask_edges(edge, part_label)
        dist_channels.append(NAT.distance_transform_map(edge))

    canny_edges = NAT.canny(np.array(img.convert("L"))) * inner_label
    edges_all = np.clip(edges + canny_edges, 0, 1).astype(np.uint8)
    channels = [edges_all * 255] + dist_channels + [np.clip(edges, 0, 1) * 255]
    return np.stack(channels, axis=-1)  # (H, W, 15) uint8


def main(argv=None) -> None:
    from cocosnet_tpu_torch.cli.common import device_for
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--load_size", type=int, default=256)
    ap.add_argument("--ids", default="0-29999",
                    help="inclusive id range, e.g. 0-29999")
    ap.add_argument("--platform", default="",
                    help="'' or gpu: the card (raises without one); cpu")
    args = ap.parse_args(argv)
    device_for(args.platform)
    lo, hi = (int(x) for x in args.ids.split("-"))
    os.makedirs(args.out, exist_ok=True)
    for idx in range(lo, hi + 1):
        img_path = os.path.join(args.dataroot, "CelebA-HQ-img", f"{idx}.jpg")
        if not os.path.exists(img_path):
            continue
        stack = build_one(args.dataroot, idx, args.load_size)
        np.save(os.path.join(args.out, f"{str(idx).zfill(5)}_edges.npy"),
                stack)
        if idx % 500 == 0:
            print(f"{idx}...", flush=True)
    print("done")


if __name__ == "__main__":
    main()
