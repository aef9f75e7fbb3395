"""Inference orchestration: builds the networks, preprocesses a batch (the
one-hot label scatter) and runs correspondence + warp + SPADE generator.

Counterpart of cocosnet_tpu/pix2pix.py for inference on the ade20k / flickr
label path. The networks are nn.Modules holding their parameters, so
`inference(nets, data)` takes no separate variables. Entry points run on
CUDA unless the caller asks for the CPU: with no GPU and no explicit
device="cpu" they raise.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cocosnet_tpu_torch.config import Options
from cocosnet_tpu_torch.models.correspondence import CorrespondenceNet
from cocosnet_tpu_torch.models.generator import SPADEGenerator
from cocosnet_tpu_torch.nn.layers import get_compute_dtype, init_weights
from cocosnet_tpu_torch.ops.image import one_hot_scatter

Batch = Dict[str, torch.Tensor]

# flags whose branches are not ported yet, with the value the port runs
_PORTED = dict(isTrain=False, match_kernel=3, mask_noise=False,
               noise_for_mask=False, use_coordconv=False, warp_patch=False,
               warp_bilinear=False, show_corr=False, warp_cycle_w=0.0,
               adaptor_res_deeper=False, adaptor_nonlocal=False,
               adaptor_se=False, mesh_model=1)


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when it is None; raises when CUDA is asked for
    (explicitly or by default) and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                           "device='cpu' to run its plain versions")
    return device


def check_ported(opt: Options) -> None:
    """Raises on a configuration whose branches the port does not have."""
    bad = {k: getattr(opt, k) for k, v in _PORTED.items()
           if getattr(opt, k) != v}
    if opt.dataset_mode not in ("ade20k", "flickr"):
        bad["dataset_mode"] = opt.dataset_mode
    if opt.warp_mask_losstype not in ("none", "direct"):
        bad["warp_mask_losstype"] = opt.warp_mask_losstype
    if bad:
        raise NotImplementedError(f"not ported yet: {bad}")


class Pix2PixNets:
    """The generator and the correspondence net, with seeded random
    weights (load real ones with convert.load_flax_variables), in eval mode
    on `device`."""

    def __init__(self, opt: Options, device=None, seed: int = 0):
        check_ported(opt)
        self.opt = opt
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.corr = CorrespondenceNet(opt)
        self.gen = SPADEGenerator(opt)
        init_weights(self.corr, gen)
        init_weights(self.gen, gen)
        self.corr.to(self.device).eval()
        self.gen.to(self.device).eval()


def cbn_input(opt: Options, warp_out: torch.Tensor,
              input_semantics: torch.Tensor) -> torch.Tensor:
    """SPADE conditioning per --CBN_intype."""
    if opt.CBN_intype == "mask":
        return input_semantics
    if opt.CBN_intype == "warp":
        return warp_out
    return torch.cat([warp_out, input_semantics], dim=-1)


def _policy_dtype(opt: Options):
    """The low-precision activation dtype when both the process policy
    (nn.layers.set_compute_dtype) and opt.compute_dtype ask for bf16."""
    dt = get_compute_dtype()
    return dt if (dt is not None and opt.compute_dtype == "bf16") else None


def preprocess_input(opt: Options, data: Dict[str, np.ndarray],
                     device=None) -> Batch:
    """One-hot scatter of the label maps (ade20k / flickr), NHWC, on
    `device`. data: label / label_ref (B, H, W, 1) raw class ids, image /
    ref (B, H, W, 3) in [-1, 1], self_ref (B,); numpy arrays or tensors."""
    device = resolve_device(device)
    t = {k: torch.as_tensor(v).to(device) for k, v in data.items()}
    nc = opt.label_nc + (1 if opt.contain_dontcare_label else 0)
    input_label = t["label"][..., 0].to(torch.int32)
    ref_label = t["label_ref"][..., 0].to(torch.int32)
    input_semantics = one_hot_scatter(input_label, nc)
    ref_semantics = one_hot_scatter(ref_label, nc)
    cdt = _policy_dtype(opt)
    if cdt is not None:
        # 0/1 is exact in bf16 and every consumer casts there anyway
        input_semantics = input_semantics.to(cdt)
        ref_semantics = ref_semantics.to(cdt)
    return dict(input_label=input_label, input_semantics=input_semantics,
                real_image=t["image"].float(), self_ref=t["self_ref"],
                ref_image=t["ref"].float(), ref_label=ref_label,
                ref_semantics=ref_semantics)


def generate_fake(nets: Pix2PixNets, data: Batch) -> Batch:
    """Correspondence + warp, then the generator on the warp-conditioned
    map. input_semantics IS one_hot(input_label) on this path, so the
    correspondence net gets the integer map for its first conv; the
    generator never sees it."""
    opt = nets.opt
    seg_label = data.get("input_label")
    corr_out = nets.corr(data["ref_image"], data["input_semantics"],
                         data["ref_semantics"], seg_label=seg_label)
    cbn = cbn_input(opt, corr_out["warp_out"], data["input_semantics"])
    out = dict(corr_out)
    out["fake_image"] = nets.gen(data["input_semantics"], cbn)
    return out


@torch.no_grad()
def inference(nets: Pix2PixNets, data: Batch) -> Batch:
    """fake_image (B, H, W, 3) f32 in [-1, 1], warp_out, warp_mask and both
    adaptive features, for a preprocessed batch."""
    return generate_fake(nets, data)
