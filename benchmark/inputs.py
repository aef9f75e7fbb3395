"""What a run feeds both sides, made from --seed on the run's device in a
few large calls: the weights, by the reference's parameter names, and the
batches of a cell's traffic.

Weights: every conv weight a standard normal draw over sqrt(fan in),
every bias 0.1 times a standard normal draw, the PReLU slopes 0.2, the
attention gates 0.5, and each spectral norm's u and v its weight's leading
singular vectors by power iteration, so that every layer passes a signal at
about unit scale (the released weights are not public in a form this
repository can hold).

Batches (the loader's NHWC dict: label, image, ref, label_ref, self_ref):
- "ids" labels (ADE20k): each sample's map is a blob layout (the argmax of
  `blobs` smooth random fields at `grid` x `grid`, bilinear to the crop)
  over `blobs` class ids drawn from the label set; the exemplar's map is
  another layout over the same ids but two. The photos are each class's
  colour plus smooth noise.
- "dense" labels (DeepFashion's pose channels): `channels` smooth fields in
  [0, 1]; smooth random photos.
- self_ref: in training the share `self_ref` of each batch (a fixed count,
  at positions drawn from the seed) has the photo as its own exemplar, as
  the loader makes one with probability 1 - real_reference_probability
  (data/pix2pix_dataset.py; 0.3 at the published 0.7); in inference none.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

Batch = Dict[str, torch.Tensor]


def _generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 4 + stream) % (2 ** 63))


def weight_kind(name: str, shape) -> str:
    if name.endswith(("weight_u", "weight_v")):
        return "spectral"
    if name.endswith(".gamma"):
        return "gate"
    if name.endswith("prelu.weight"):
        return "prelu"
    if name.endswith(".bias"):
        return "bias"
    if len(shape) >= 2:
        return "weight"
    raise ValueError(f"no rule for weight {name} {tuple(shape)}")


def make_weights(shapes: Dict[str, tuple], seed: int, device,
                 power_iterations: int = 30) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on device} for the reference's state-dict names and
    shapes, from one draw of the seed."""
    names = sorted(shapes)
    drawn = [n for n in names
             if weight_kind(n, shapes[n]) in ("weight", "bias")]
    total = sum(int(torch.Size(shapes[n]).numel()) for n in drawn)
    flat = torch.randn(total, generator=_generator(device, seed, 0),
                       device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for n in drawn:
        shape = torch.Size(shapes[n])
        t = flat[at: at + shape.numel()].view(shape)
        at += shape.numel()
        out[n] = (t * 0.1 if weight_kind(n, shape) == "bias"
                  else t * (shape[1:].numel() ** -0.5))
    for n in names:
        kind = weight_kind(n, shapes[n])
        if kind == "gate":
            out[n] = torch.full(shapes[n], 0.5, device=device)
        elif kind == "prelu":
            out[n] = torch.full(shapes[n], 0.2, device=device)
    for n in names:
        if n.endswith("weight_u"):
            base = n[: -len("weight_u")]
            wm = out[base + "weight_orig"].reshape(shapes[n][0], -1)
            u = torch.ones(wm.shape[0], device=device) / wm.shape[0] ** 0.5
            for _ in range(power_iterations):
                v = F.normalize(wm.t() @ u, dim=0)
                u = F.normalize(wm @ v, dim=0)
            out[n], out[base + "weight_v"] = u, v
    return out


def _smooth(g, b, c, grid, size, device) -> torch.Tensor:
    """(B, C, size, size) smooth standard fields: bilinear from grid^2."""
    low = torch.randn(b, c, grid, grid, generator=g, device=device)
    return F.interpolate(low, size=(size, size), mode="bilinear",
                         align_corners=False)


def _blob_map(g, b, blobs, grid, size, ids, device) -> torch.Tensor:
    """(B, size, size) class ids: blob index through the per-sample ids."""
    idx = _smooth(g, b, blobs, grid, size, device).argmax(1)
    return torch.gather(ids, 1, idx.reshape(b, -1)).reshape(b, size, size)


def make_batches(traffic: dict, model: dict, seed: int, device,
                 train: bool) -> List[Batch]:
    """traffic["pool"] distinct batches of traffic["batch"] samples (NHWC,
    f32, on device) for the model's label mode."""
    spec = traffic["inputs"]
    n, b, size = traffic["pool"], traffic["batch"], model["crop_size"]
    g = _generator(device, seed, 1)
    grid = spec["grid"]
    out = []
    for _ in range(n):
        if model["label_mode"] == "ids":
            nc, k = model["semantic_nc"], spec["blobs"]
            ids = torch.randint(0, nc, (b, k), generator=g, device=device)
            ref_ids = ids.clone()
            ref_ids[:, :2] = torch.randint(0, nc, (b, 2), generator=g,
                                           device=device)
            label = _blob_map(g, b, k, grid, size, ids, device)
            label_ref = _blob_map(g, b, k, grid, size, ref_ids, device)
            palette = torch.rand(nc, 3, generator=g, device=device) * 1.6 - 0.8

            def photo(lab):
                noise = _smooth(g, b, 3, 4 * grid, size, device) * 0.15
                return (palette[lab] + noise.permute(0, 2, 3, 1)).clamp(-1, 1)

            image, ref = photo(label), photo(label_ref)
            label = label[..., None].float()
            label_ref = label_ref[..., None].float()
        else:
            c = spec["channels"]
            label = torch.sigmoid(2 * _smooth(g, b, c, grid, size, device)
                                  ).permute(0, 2, 3, 1)
            label_ref = torch.sigmoid(2 * _smooth(g, b, c, grid, size, device)
                                      ).permute(0, 2, 3, 1)
            image = torch.tanh(_smooth(g, b, 3, 2 * grid, size, device)
                               ).permute(0, 2, 3, 1)
            ref = torch.tanh(_smooth(g, b, 3, 2 * grid, size, device)
                             ).permute(0, 2, 3, 1)
        self_ref = torch.zeros(b, device=device)
        if train:
            own = torch.randperm(b, generator=g, device=device)[
                : round(spec["self_ref"] * b)]
            self_ref[own] = 1.0
            keep = self_ref[:, None, None, None] > 0
            ref = torch.where(keep, image, ref)
            label_ref = torch.where(keep, label, label_ref)
        out.append({"label": label.contiguous(), "image": image.contiguous(),
                    "ref": ref.contiguous(),
                    "label_ref": label_ref.contiguous(), "self_ref": self_ref})
    return out
