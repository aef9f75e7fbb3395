"""Quality metrics for generated images: SWD and FID. Twin of
tools/eval_metrics.py: `swd`, `fid_from_features` and `load_image_dir` are
copied from it; the feature extractors run on the port's device.

The CoCosNet paper reports FID and SWD against the real test distribution
(BASELINE.md: ade20k FID 26.4 / SWD 10.5, celebahqedge 14.3/15.2,
deepfashion 14.4/17.2). The reference repo ships NO evaluation code; these
are the standard third-party definitions:

- SWD: sliced Wasserstein distance over Laplacian-pyramid patch descriptors
  (Karras et al., "Progressive Growing of GANs", appendix A; the metric the
  paper's SWDx10^2 column uses). Weight-free, numpy, deterministic (fixed
  seed) so runs are comparable.
- FID: Frechet distance between Gaussians fitted to pooled features of an
  image-classifier backbone (Heusel et al. 2017). --feature vgg (the
  default): the port's VGG19 (nn/vgg.VGG19Features) relu5_2 features,
  averaged over space, in f32 with TF32 off, its weights read by
  train/checkpoints.load_vgg from assets/vgg19_conv.npz or its .pth (neither
  is in the repository: without them the features are random and the FID
  meaningless; the CLI warns). VGG-FID values are NOT comparable to the
  paper's Inception-FID numbers: use them to track runs and checkpoints.
  --feature inception: torchvision's InceptionV3 pool3 (paper-comparable);
  it raises where torchvision or its pretrained weights are absent.

    python -m cocosnet_tpu_torch.tools.eval_metrics --fake_dir A \
        --real_dir B [--metrics swd,fid] [--feature vgg] [--max_images N] \
        [--out m.json] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
VGG_WEIGHTS = os.path.join(ROOT, "assets", "vgg19_conv.npz")


# --------------------------------------------------------------------- SWD

def _laplacian_pyramid(batch: np.ndarray, levels: int):
    """batch: (N,H,W,3) float32 in [0,255]. Returns list of (N,h,w,3) bands,
    finest first, via 5x5 binomial blur + 2x decimation (PGGAN appendix A)."""
    k1 = np.array([1., 4., 6., 4., 1.], np.float32)
    k2 = np.outer(k1, k1)
    k2 /= k2.sum()

    def blur(x):
        # separable 5x5 binomial, reflect padding, NHWC
        from scipy.ndimage import convolve
        out = np.empty_like(x)
        for n in range(x.shape[0]):
            for c in range(3):
                out[n, :, :, c] = convolve(x[n, :, :, c], k2, mode="reflect")
        return out

    pyramid = []
    cur = batch
    for _ in range(levels - 1):
        low = blur(cur)[:, ::2, ::2]
        up = np.repeat(np.repeat(low, 2, axis=1), 2, axis=2)
        up = blur(up.astype(np.float32))
        pyramid.append(cur - up[:, :cur.shape[1], :cur.shape[2]])
        cur = low
    pyramid.append(cur)
    return pyramid


def _patch_descriptors(band: np.ndarray, n_patches: int, rng: np.random.RandomState,
                       patch: int = 7) -> np.ndarray:
    """Random 7x7x3 patches, normalized per channel over the patch set."""
    n, h, w, _ = band.shape
    idx_img = rng.randint(0, n, n_patches)
    ys = rng.randint(0, h - patch + 1, n_patches)
    xs = rng.randint(0, w - patch + 1, n_patches)
    out = np.empty((n_patches, patch, patch, 3), np.float32)
    for i, (ii, y, x) in enumerate(zip(idx_img, ys, xs)):
        out[i] = band[ii, y:y + patch, x:x + patch]
    mu = out.mean(axis=(0, 1, 2), keepdims=True)
    sd = out.std(axis=(0, 1, 2), keepdims=True) + 1e-8
    out = (out - mu) / sd
    return out.reshape(n_patches, -1)


def _sliced_wasserstein(a: np.ndarray, b: np.ndarray, n_proj: int,
                        rng: np.random.RandomState) -> float:
    d = a.shape[1]
    dist = 0.0
    reps = 4
    for _ in range(reps):
        proj = rng.randn(d, n_proj).astype(np.float32)
        proj /= np.linalg.norm(proj, axis=0, keepdims=True) + 1e-12
        pa = np.sort(a @ proj, axis=0)
        pb = np.sort(b @ proj, axis=0)
        dist += float(np.mean(np.abs(pa - pb)))
    return dist / reps


def swd(fake: np.ndarray, real: np.ndarray, n_patches: int = 8192,
        n_proj: int = 128, seed: int = 0, min_size: int = 16):
    """PGGAN sliced Wasserstein distance. fake/real: (N,H,W,3) uint8 or
    float in [0,255]. Returns {level_size: swd*1e2, 'avg': mean} — the
    paper's SWDx10^2 convention."""
    fake = np.asarray(fake, np.float32)
    real = np.asarray(real, np.float32)
    h = fake.shape[1]
    levels = 1
    while h // (2 ** levels) >= min_size:
        levels += 1
    pf = _laplacian_pyramid(fake, levels)
    pr = _laplacian_pyramid(real, levels)
    out = {}
    vals = []
    for lf, lr in zip(pf, pr):
        rng = np.random.RandomState(seed)
        npatch = min(n_patches, lf.shape[0] * 128)
        da = _patch_descriptors(lf, npatch, rng)
        rng = np.random.RandomState(seed)
        db = _patch_descriptors(lr, npatch, rng)
        rng = np.random.RandomState(seed + 1)
        v = _sliced_wasserstein(da, db, n_proj, rng) * 1e2
        out[int(lf.shape[1])] = v
        vals.append(v)
    out["avg"] = float(np.mean(vals))
    return out


# --------------------------------------------------------------------- FID

def fid_from_features(f1: np.ndarray, f2: np.ndarray) -> float:
    """Frechet distance between N(mu1,C1) and N(mu2,C2) fitted to (N,D)
    feature matrices."""
    mu1, mu2 = f1.mean(0), f2.mean(0)
    c1 = np.cov(f1, rowvar=False)
    c2 = np.cov(f2, rowvar=False)
    diff = mu1 - mu2
    # sqrtm(c1 @ c2) via scipy when present, else eigen fallback
    try:
        from scipy import linalg
        covmean = linalg.sqrtm(c1 @ c2)
        if np.iscomplexobj(covmean):
            covmean = covmean.real
        tr_covmean = np.trace(covmean)
    except ImportError:
        w, v = np.linalg.eigh((c1 @ c2 + (c1 @ c2).T) / 2)
        tr_covmean = np.sum(np.sqrt(np.maximum(w, 0)))
    return float(diff @ diff + np.trace(c1) + np.trace(c2) - 2 * tr_covmean)


# ----------------------------------------------------------- features

def vgg_features(vgg: torch.nn.Module, images: np.ndarray,
                 batch_size: int = 8) -> np.ndarray:
    """(N, H, W, 3) in [0, 255] -> (N, 512): the relu5_2 activations of
    `vgg` (nn/vgg.VGG19Features) averaged over space, batch_size images at
    a time, in f32 with TF32 off, on the module's device."""
    device = next(vgg.parameters()).device
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    outs = []
    try:
        with torch.no_grad():
            for i in range(0, len(images), batch_size):
                x = torch.from_numpy(np.asarray(
                    images[i:i + batch_size], np.float32) / 127.5 - 1.0)
                feats = vgg(x.to(device), ["r52"])[0]
                outs.append(feats.mean(dim=(1, 2)).cpu().numpy())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return np.concatenate(outs)


def vgg_feature_extractor(batch_size: int = 8, device="cuda",
                          weights: str = VGG_WEIGHTS):
    """images -> vgg_features of the port's VGG19 (--vgg_normal_correct's
    preprocessing, as the losses run it) with the weights of `weights` (its
    .npz, or the .pth beside it) when either exists; `loaded_weights` says
    which it read, None for the seeded random tower (`vgg`, the module)."""
    from cocosnet_tpu_torch.nn.layers import init_weights
    from cocosnet_tpu_torch.nn.vgg import VGG19Features
    from cocosnet_tpu_torch.train.checkpoints import load_vgg
    vgg = VGG19Features(vgg_normal_correct=True)
    init_weights(vgg, torch.Generator().manual_seed(0))
    vgg.to(device).eval()
    loaded = load_vgg(SimpleNamespace(vgg_weights=weights),
                      SimpleNamespace(vgg=vgg, device=torch.device(device)))

    def extract(images: np.ndarray) -> np.ndarray:
        return vgg_features(vgg, images, batch_size)

    extract.loaded_weights = loaded
    extract.vgg = vgg
    return extract


def inception_feature_extractor(batch_size: int = 8, device="cuda"):
    """torchvision InceptionV3 pool3 (paper-standard FID) on `device`.
    Raises if torchvision or its pretrained weights cannot be loaded
    (machines without network or a weights cache)."""
    from torchvision.models import inception_v3

    net = inception_v3(weights="IMAGENET1K_V1", aux_logits=True).eval()
    layers = torch.nn.Sequential(
        net.Conv2d_1a_3x3, net.Conv2d_2a_3x3, net.Conv2d_2b_3x3,
        torch.nn.MaxPool2d(3, 2), net.Conv2d_3b_1x1, net.Conv2d_4a_3x3,
        torch.nn.MaxPool2d(3, 2), net.Mixed_5b, net.Mixed_5c, net.Mixed_5d,
        net.Mixed_6a, net.Mixed_6b, net.Mixed_6c, net.Mixed_6d, net.Mixed_6e,
        net.Mixed_7a, net.Mixed_7b, net.Mixed_7c,
        torch.nn.AdaptiveAvgPool2d(1)).to(device)

    def extract(images: np.ndarray) -> np.ndarray:
        outs = []
        with torch.no_grad():
            for i in range(0, len(images), batch_size):
                x = torch.from_numpy(
                    np.asarray(images[i:i + batch_size], np.float32) / 255.0)
                x = x.permute(0, 3, 1, 2).to(device)
                x = torch.nn.functional.interpolate(
                    x, size=(299, 299), mode="bilinear", align_corners=False)
                x = (x - 0.5) / 0.5
                outs.append(layers(x).squeeze(-1).squeeze(-1).cpu().numpy())
        return np.concatenate(outs)

    return extract


# ---------------------------------------------------------------------- IO

def load_image_dir(path: str, max_images: int = 0, size: int = 0) -> np.ndarray:
    from PIL import Image
    exts = (".png", ".jpg", ".jpeg", ".webp", ".bmp")
    files = sorted(
        os.path.join(r, f) for r, _, fs in os.walk(path)
        for f in fs if f.lower().endswith(exts))
    if max_images:
        files = files[:max_images]
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    imgs = []
    for f in files:
        im = Image.open(f).convert("RGB")
        if size:
            im = im.resize((size, size), Image.BICUBIC)
        imgs.append(np.asarray(im, np.uint8))
    return np.stack(imgs)




def main(argv=None) -> dict:
    from cocosnet_tpu_torch.cli.common import device_for
    ap = argparse.ArgumentParser()
    ap.add_argument("--fake_dir", required=True)
    ap.add_argument("--real_dir", required=True)
    ap.add_argument("--metrics", default="swd,fid")
    ap.add_argument("--feature", default="vgg", choices=["vgg", "inception"])
    ap.add_argument("--max_images", type=int, default=0)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default="")
    ap.add_argument("--platform", default="",
                    help="'' or gpu: the card (raises without one); cpu")
    ap.add_argument("--vgg_weights", default=VGG_WEIGHTS)
    args = ap.parse_args(argv)
    device = device_for(args.platform)

    fake = load_image_dir(args.fake_dir, args.max_images, args.size)
    real = load_image_dir(args.real_dir, args.max_images, args.size)
    print(f"{len(fake)} fake vs {len(real)} real images at {args.size}px")

    results = {}
    if "swd" in args.metrics:
        results["swd_x100"] = swd(fake, real)
        print(f"SWD x100: {results['swd_x100']}")
    if "fid" in args.metrics:
        if args.feature == "inception":
            extract = inception_feature_extractor(device=device)
            key = "fid_inception"
        else:
            extract = vgg_feature_extractor(device=device,
                                            weights=args.vgg_weights)
            key = "fid_vgg"
            if not extract.loaded_weights:
                print(f"WARNING: {args.vgg_weights} (or its .pth) missing: "
                      "FID uses RANDOM features and is meaningless",
                      file=sys.stderr)
        results[key] = fid_from_features(extract(fake), extract(real))
        print(f"{key}: {results[key]:.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
