"""Model orchestration: builds the networks, preprocesses a batch (the
one-hot label scatter), runs correspondence + warp + SPADE generator, and
assembles the generator's 11-term and the discriminator's objectives.

Counterpart of cocosnet_tpu/pix2pix.py on the ade20k / flickr label path.
The networks are nn.Modules holding their parameters, so the functions
take no separate variables. Entry points run on CUDA unless the caller asks
for the CPU: with no GPU and no explicit device="cpu" they raise.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cocosnet_tpu_torch.config import Options
from cocosnet_tpu_torch.losses.contextual import contextual_loss
from cocosnet_tpu_torch.losses.gan import (feature_matching_loss, gan_loss,
                                           mse_loss, weighted_l1_loss)
from cocosnet_tpu_torch.models.correspondence import CorrespondenceNet
from cocosnet_tpu_torch.models.discriminator import MultiscaleDiscriminator
from cocosnet_tpu_torch.models.generator import SPADEGenerator
from cocosnet_tpu_torch.nn.layers import get_compute_dtype, init_weights
from cocosnet_tpu_torch.nn.vgg import VGG19Features
from cocosnet_tpu_torch.ops.image import (avg_pool, one_hot_scatter,
                                          resize_nearest)

Batch = Dict[str, torch.Tensor]

VGG_KEYS = ["r12", "r22", "r32", "r42", "r52"]
FM_WEIGHTS = [1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0]

# flags whose branches are not ported yet, with the value the port runs
_PORTED = dict(mask_noise=False, noise_for_mask=False,
               use_coordconv=False, warp_patch=False, warp_bilinear=False,
               show_corr=False, warp_cycle_w=0.0, adaptor_res_deeper=False,
               adaptor_nonlocal=False, adaptor_se=False, mesh_model=1,
               D_cam=0.0, D_steps_per_G=1, remat=False, remat_full=False,
               netD="multiscale", netD_subarch="n_layer")


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
    if opt.match_kernel not in (1, 3):
        bad["match_kernel"] = opt.match_kernel
    if opt.dataset_mode not in ("ade20k", "flickr"):
        bad["dataset_mode"] = opt.dataset_mode
    if opt.warp_mask_losstype not in ("none", "direct"):
        bad["warp_mask_losstype"] = opt.warp_mask_losstype
    if opt.weight_domainC > 0 and opt.domain_rela:
        bad["weight_domainC"] = opt.weight_domainC
    if bad:
        raise NotImplementedError(f"not ported yet: {bad}")


class Pix2PixNets:
    """The generator and the correspondence net, and with opt.isTrain the
    multiscale discriminator and the frozen VGG19, with seeded random
    weights (load real ones with convert.load_flax_variables), in eval mode
    on `device`. A train step puts gen, corr and disc in train mode
    (`set_train`) for its own extent."""

    def __init__(self, opt: Options, device=None, seed: int = 0):
        check_ported(opt)
        self.opt = opt
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.corr = CorrespondenceNet(opt)
        self.gen = SPADEGenerator(opt)
        self.disc = MultiscaleDiscriminator(opt) if opt.isTrain else None
        self.vgg = (VGG19Features(opt.vgg_normal_correct) if opt.isTrain
                    else None)
        self.perceptual_layer = -1 if opt.which_perceptual == "5_2" else -2
        for net in self.modules():
            init_weights(net, gen)
            net.to(self.device).eval()

    def modules(self) -> List[torch.nn.Module]:
        return [m for m in (self.corr, self.gen, self.disc, self.vgg)
                if m is not None]

    def set_train(self, flag: bool) -> None:
        """Train mode advances every spectral norm's power iteration."""
        for net in (self.corr, self.gen, self.disc):
            if net is not None:
                net.train(flag)


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
                real_image=t["image"].float(), self_ref=t["self_ref"].float(),
                ref_image=t["ref"].float(), ref_label=ref_label,
                ref_semantics=ref_semantics)


def generate_fake(nets: Pix2PixNets, data: Batch,
                  train: bool = False) -> Batch:
    """Correspondence + warp, then the generator on the warp-conditioned
    map. In inference input_semantics IS one_hot(input_label) on this path,
    so the correspondence net gets the integer map for its first conv (the
    generator never sees it); training keeps the dense one-hot, as the JAX
    package does (its one-hot kernel has no backward), and hands the
    correspondence net the real image for its feature-pair loss."""
    opt = nets.opt
    kw = {}
    if train:
        kw["real_img"] = data["real_image"]
    elif "input_label" in data:
        kw["seg_label"] = data["input_label"]
    corr_out = nets.corr(data["ref_image"], data["input_semantics"],
                         data["ref_semantics"], **kw)
    cbn = cbn_input(opt, corr_out["warp_out"], data["input_semantics"])
    out = dict(corr_out)
    out["fake_image"] = nets.gen(data["input_semantics"], cbn)
    return out


@torch.no_grad()
def inference(nets: Pix2PixNets, data: Batch) -> Batch:
    """fake_image (B, H, W, 3) f32 in [-1, 1], warp_out, warp_mask and both
    adaptive features, for a preprocessed batch."""
    return generate_fake(nets, data)


# ------------------------------------------------------------ training

def discriminate(nets: Pix2PixNets, input_semantics: torch.Tensor,
                 fake_image: torch.Tensor, real_image: torch.Tensor):
    """(pred_fake, pred_real), per scale the list of D's features with the
    logit map last. Fake and real go through D as ONE batch
    (pix2pix_model.py:342-353), in the policy dtype."""
    cdt = _policy_dtype(nets.opt)
    if cdt is not None:
        fake_image = fake_image.to(cdt)
        real_image = real_image.to(cdt)
        input_semantics = input_semantics.to(cdt)
    fake_and_real = torch.cat([
        torch.cat([input_semantics, fake_image], -1),
        torch.cat([input_semantics, real_image], -1)], 0)
    outs = nets.disc(fake_and_real)
    pred_fake = [[t[: t.shape[0] // 2] for t in scale] for scale in outs]
    pred_real = [[t[t.shape[0] // 2:] for t in scale] for scale in outs]
    return pred_fake, pred_real


def vgg_features(nets: Pix2PixNets, img: torch.Tensor) -> List[torch.Tensor]:
    return nets.vgg(img, VGG_KEYS)


def get_ctx_loss(opt: Options, source, target) -> torch.Tensor:
    """pix2pix_model.py:196-203: contextual loss at r5_2 (x8), r4_2 (x4),
    r3_2 avg-pooled (x2) and, with --use_22ctx, r2_2 avg-pooled (x1);
    targets detached."""
    def ctx(x, y):
        return contextual_loss(x, y.detach(), pono=opt.PONO).mean()
    loss = ctx(source[-1], target[-1]) * 8
    loss = loss + ctx(source[-2], target[-2]) * 4
    loss = loss + ctx(avg_pool(source[-3], 2), avg_pool(target[-3], 2)) * 2
    if opt.use_22ctx:
        loss = loss + ctx(avg_pool(source[-4], 4), avg_pool(target[-4], 4))
    return loss


def warp_mask_loss(opt: Options, warp_mask: torch.Tensor,
                   input_label: torch.Tensor,
                   ref_label: torch.Tensor) -> torch.Tensor:
    """NLL of log(warp_mask) against the label map downsampled to the warp
    grid, zeroing classes absent from the exemplar and class 0
    (pix2pix_model.py:261-276), with the per-sample class scan as a
    presence table."""
    b, fh, fw, nc = warp_mask.shape
    gt = resize_nearest(input_label[..., None].float(), fh, fw)[..., 0]
    ref = resize_nearest(ref_label[..., None].float(), fh, fw)[..., 0]
    gt = gt.long().reshape(b, -1)
    presence = one_hot_scatter(ref.long(), nc).amax(dim=(1, 2))  # (B, nc)
    w = torch.gather(presence, 1, gt)
    w = torch.where(gt == 0, torch.zeros_like(w), w)
    logp = torch.log(warp_mask.float() + 1e-10).reshape(b, -1, nc)
    nll = -torch.gather(logp, 2, gt[..., None])[..., 0]
    return (nll * w).sum() / (w.sum() + 1e-5) * opt.weight_mask


def compute_generator_losses(nets: Pix2PixNets, data: Batch,
                             generate_out: Batch) -> Dict[str, torch.Tensor]:
    """pix2pix_model.py:205-279: the generator's loss terms. generate_out
    holds generate_fake's outputs plus `real_features` and `ref_features`
    (the VGG taps of the real and the exemplar image). D runs here in
    whatever mode it is in: in train mode its power iterations advance, as
    torch's pre-hook advances them on this forward too."""
    opt = nets.opt
    losses: Dict[str, torch.Tensor] = {}
    if "loss_novgg_featpair" in generate_out:
        losses["no_vgg_feat"] = generate_out["loss_novgg_featpair"]
    real_image = data["real_image"]
    self_ref = data["self_ref"]
    sample_weights = (self_ref / (self_ref.sum() + 1e-5))[:, None, None, None]
    if opt.warp_self_w > 0:
        losses["G_warp_self"] = ((generate_out["warp_out"] - real_image).abs()
                                 * sample_weights).mean() * opt.warp_self_w

    pred_fake, pred_real = discriminate(nets, data["input_semantics"],
                                        generate_out["fake_image"], real_image)
    losses["GAN"] = gan_loss(pred_fake, True, for_discriminator=False,
                             gan_mode=opt.gan_mode) * opt.weight_gan
    if not opt.no_ganFeat_loss:
        losses["GAN_Feat"] = (feature_matching_loss(pred_fake, pred_real)
                              * opt.lambda_feat)

    fake_features = vgg_features(nets, generate_out["fake_image"])
    real_features = generate_out["real_features"]
    fm = 0.0
    for w, ff, rf in zip(FM_WEIGHTS, fake_features, real_features):
        fm = fm + w * weighted_l1_loss(ff, rf.detach(), sample_weights)
    losses["fm"] = fm * opt.lambda_vgg * opt.fm_ratio
    pl = nets.perceptual_layer
    losses["perc"] = mse_loss(fake_features[pl],
                              real_features[pl].detach()) * opt.weight_perceptual
    losses["contextual"] = (get_ctx_loss(opt, fake_features,
                                         generate_out["ref_features"])
                            * opt.lambda_vgg * opt.ctx_w)
    if opt.warp_mask_losstype != "none":
        losses["mask"] = warp_mask_loss(opt, generate_out["warp_mask"],
                                        data["input_label"], data["ref_label"])
    return losses


def compute_discriminator_losses(nets: Pix2PixNets, data: Batch,
                                 fake_image: torch.Tensor
                                 ) -> Dict[str, torch.Tensor]:
    """pix2pix_model.py:281-296: the GAN loss of D on the detached fake and
    the real image."""
    opt = nets.opt
    pred_fake, pred_real = discriminate(nets, data["input_semantics"],
                                        fake_image.detach(),
                                        data["real_image"])
    return {
        "D_Fake": gan_loss(pred_fake, False, for_discriminator=True,
                           gan_mode=opt.gan_mode) * opt.weight_gan,
        "D_real": gan_loss(pred_real, True, for_discriminator=True,
                           gan_mode=opt.gan_mode) * opt.weight_gan,
    }
