"""SPADE generator, the adaptive-feature domain adaptor, the domain
classifier and the gradient reversal.

Counterpart of cocosnet_tpu/models/generator.py (SPADEGenerator,
AdaptiveFeatureGenerator, DomainClassifier, grad_reverse): NHWC tensors;
train mode (batch statistics, spectral power iterations) follows the
module's own mode. With --remat each SPADE block is recomputed in the
backward under --remat_policy (nn/remat.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as tnn

from cocosnet_tpu_torch.config import Options
from cocosnet_tpu_torch.nn.blocks import Attention, SPADEResnetBlock
from cocosnet_tpu_torch.nn.layers import (Conv2d, Linear, get_compute_dtype,
                                          leaky_relu)
from cocosnet_tpu_torch.nn.norms import BatchNorm, NormConv
from cocosnet_tpu_torch.ops.image import resize_nearest, upsample_nearest


def spade_config_str(opt: Options) -> str:
    return opt.norm_G.replace("spectral", "")


def remat_policy(opt: Options) -> Optional[str]:
    """The SPADE blocks' recompute policy: --remat_policy under --remat,
    else None (no recompute)."""
    return (opt.remat_policy or "block") if opt.remat else None


def cbn_channels(opt: Options) -> int:
    """Channels of the SPADE conditioning input per --CBN_intype."""
    ic = 0
    if "warp" in opt.CBN_intype:
        ic += 3
    if "mask" in opt.CBN_intype:
        ic += opt.semantic_nc
    return ic


def _to_compute(x):
    dt = get_compute_dtype()
    return x if dt is None else x.to(dt)


class SPADEGenerator(tnn.Module):
    """3x3 `fc` conv on the conditioning map downsampled to crop/32, seven
    SPADE resblocks with x2 nearest upsampling, optional attention at 4nf,
    tanh head."""

    def __init__(self, opt: Options):
        super().__init__()
        self.opt = opt
        nf = opt.ngf
        use_sn = "spectral" in opt.norm_G
        cfg = spade_config_str(opt)
        ic = cbn_channels(opt)

        def block(fin, fout):
            return SPADEResnetBlock(fin, fout, cfg, ic, use_spectral=use_sn,
                                    eqlr_sn=opt.eqlr_sn, pono=opt.PONO,
                                    remat_policy=remat_policy(opt))

        self.fc = Conv2d(ic, 16 * nf, 3, padding=1,
                         weight_norm="equal_lr" if opt.eqlr_sn else None)
        self.head_0 = block(16 * nf, 16 * nf)
        self.G_middle_0 = block(16 * nf, 16 * nf)
        self.G_middle_1 = block(16 * nf, 16 * nf)
        self.up_0 = block(16 * nf, 8 * nf)
        self.up_1 = block(8 * nf, 4 * nf)
        if opt.use_attention:
            self.attn = Attention(4 * nf, use_sn)
        self.up_2 = block(4 * nf, 2 * nf)
        self.up_3 = block(2 * nf, nf)
        self.conv_img = Conv2d(nf, 3, 3, padding=1)

    def forward(self, input_semantics: torch.Tensor,
                warp_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        opt = self.opt
        seg = _to_compute(input_semantics if warp_out is None else warp_out)
        sw = opt.crop_size // (2 ** 5)
        sh = round(sw / opt.aspect_ratio)
        x = self.fc(resize_nearest(seg, sh, sw))
        x = self.head_0(x, seg)
        x = upsample_nearest(x, 2)
        x = self.G_middle_0(x, seg)
        x = self.G_middle_1(x, seg)
        x = upsample_nearest(x, 2)
        x = self.up_0(x, seg)
        x = upsample_nearest(x, 2)
        x = self.up_1(x, seg)
        x = upsample_nearest(x, 2)
        if opt.use_attention:
            x = self.attn(x)
        x = self.up_2(x, seg)
        x = upsample_nearest(x, 2)
        x = self.up_3(x, seg)
        x = self.conv_img(leaky_relu(x))
        return torch.tanh(x.float())


class AdaptiveFeatureGenerator(tnn.Module):
    """Domain adaptor mapping a semantic map or an RGB image into the shared
    correspondence domain at 1/4 resolution, 4nf channels. spade_ic is the
    input (and conditioning) channel count: semantic_nc or 3."""

    def __init__(self, opt: Options, spade_ic: int):
        super().__init__()
        self.opt = opt
        ndf = nf = opt.ngf
        ak = opt.adaptor_kernel
        use_sn = "spectral" in opt.norm_G
        cfg = spade_config_str(opt)

        def nconv(cin, feat, ks, stride, dilation=1, pad=1):
            return NormConv(cin, feat, ks, opt.norm_E, stride=stride,
                            padding=pad, dilation=dilation,
                            eqlr_sn=opt.eqlr_sn)

        def block(fin, fout, use_se=False, dilation=1):
            return SPADEResnetBlock(fin, fout, cfg, spade_ic,
                                    use_spectral=use_sn, eqlr_sn=opt.eqlr_sn,
                                    pono=opt.PONO, use_se=use_se,
                                    dilation=dilation,
                                    remat_policy=remat_policy(opt))

        self.layer1 = nconv(spade_ic, ndf, 3, 1)
        self.layer2 = nconv(ndf, ndf * 2, ak, 2)
        self.layer3 = nconv(ndf * 2, ndf * 4, 3, 1)
        if opt.warp_stride == 2:
            self.layer4 = nconv(ndf * 4, ndf * 8, 3, 1)
        else:
            self.layer4 = nconv(ndf * 4, ndf * 8, ak, 2)
        self.layer5 = nconv(ndf * 8, ndf * 8, 3, 1)
        se = opt.adaptor_se
        self.head_0 = block(8 * nf, 8 * nf, use_se=se)
        if opt.adaptor_nonlocal:
            self.attn = Attention(8 * nf, False)
        self.G_middle_0 = block(8 * nf, 8 * nf, use_se=se)
        self.G_middle_1 = block(8 * nf, 4 * nf, use_se=se)
        # --adaptor_res_deeper: three more blocks; with --dilation_conv the
        # last two dilated 2 and 4, then two de-gridding convs
        # (generator.py:171-186)
        self.deeper = []
        if opt.adaptor_res_deeper:
            dil = (1, 2, 4) if opt.dilation_conv else (1, 1, 1)
            for i, d in enumerate(dil):
                self.add_module(f"deeper{i}", block(4 * nf, 4 * nf,
                                                    dilation=d))
                self.deeper.append(f"deeper{i}")
            if opt.dilation_conv:
                self.degridding0 = nconv(ndf * 4, ndf * 4, 3, 1, dilation=2,
                                         pad=2)
                self.degridding1 = nconv(ndf * 4, ndf * 4, 3, 1)

    def forward(self, x, seg: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, spade_ic) tensor or OneHotLabels; seg: the dense
        conditioning map."""
        opt = self.opt
        x = _to_compute(x)
        seg = _to_compute(seg)
        h = self.layer1(x)
        h = self.layer2(leaky_relu(h))
        h = self.layer3(leaky_relu(h))
        h = self.layer4(leaky_relu(h))
        h = self.layer5(leaky_relu(h))
        h = self.head_0(h, seg)
        if opt.adaptor_nonlocal:
            h = self.attn(h)
        h = self.G_middle_0(h, seg)
        h = self.G_middle_1(h, seg)
        for name in self.deeper:
            h = self._modules[name](h, seg)
        if opt.adaptor_res_deeper and opt.dilation_conv:
            h = self.degridding1(self.degridding0(h))
        return h


class DomainClassifier(tnn.Module):
    """The domain-adversarial head (generator.py:189-214), built with
    --weight_domainC > 0 and --domain_rela; no loss calls it, as in the
    JAX package and the reference. Three stride-2 convs, each with an
    affine BatchNorm and LeakyReLU(0.2), then dense 100 with a BatchNorm1d
    and ReLU, then one relativistic logit (--domain_rela) or two
    log-softmax classes. The JAX package's names."""

    def __init__(self, opt: Options):
        super().__init__()
        self.opt = opt
        nf = opt.ngf
        kw = 4 if opt.domain_rela else 3
        pw = (kw - 1) // 2
        cin = 4 * nf
        for i, feat in enumerate([2 * nf, nf, nf // 2]):
            self.add_module(f"feature_{i}", Conv2d(cin, feat, kw, stride=2,
                                                   padding=pw))
            self.add_module(f"bn_{i}", BatchNorm(feat, affine=True))
            cin = feat
        # the flattened map of a crop/4 input after three stride-2 convs
        side = opt.crop_size // 4
        for _ in range(3):
            side = (side + 2 * pw - kw) // 2 + 1
        self.fc0 = Linear(cin * side * side, 100)
        self.bn_fc = BatchNorm(100, affine=True)
        self.fc1 = Linear(100, 1 if opt.domain_rela else 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(3):
            h = self._modules[f"feature_{i}"](h)
            h = leaky_relu(self._modules[f"bn_{i}"](h))
        # torch flattens NCHW (C, H, W)
        h = h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)
        h = torch.relu(self.bn_fc(self.fc0(h)))
        h = self.fc1(h)
        return h if self.opt.domain_rela else torch.log_softmax(h, dim=1)


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def grad_reverse(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """ReverseLayerF (generator.py:217-231): identity forward, -alpha * g
    backward."""
    return _GradReverse.apply(x, alpha)
