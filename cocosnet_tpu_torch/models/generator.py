"""SPADE generator and the adaptive-feature domain adaptor.

Counterpart of cocosnet_tpu/models/generator.py (SPADEGenerator,
AdaptiveFeatureGenerator), flagship branches: NHWC tensors, eval mode.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as tnn

from cocosnet_tpu_torch.config import Options
from cocosnet_tpu_torch.nn.blocks import Attention, SPADEResnetBlock
from cocosnet_tpu_torch.nn.layers import Conv2d, get_compute_dtype, leaky_relu
from cocosnet_tpu_torch.nn.norms import NormConv
from cocosnet_tpu_torch.ops.image import resize_nearest, upsample_nearest


def spade_config_str(opt: Options) -> str:
    return opt.norm_G.replace("spectral", "")


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
                                    eqlr_sn=opt.eqlr_sn, pono=opt.PONO)

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
        ndf = nf = opt.ngf
        ak = opt.adaptor_kernel
        use_sn = "spectral" in opt.norm_G
        cfg = spade_config_str(opt)

        def nconv(cin, feat, ks, stride):
            return NormConv(cin, feat, ks, opt.norm_E, stride=stride,
                            padding=1, eqlr_sn=opt.eqlr_sn)

        def block(fin, fout):
            return SPADEResnetBlock(fin, fout, cfg, spade_ic,
                                    use_spectral=use_sn, eqlr_sn=opt.eqlr_sn,
                                    pono=opt.PONO)

        self.layer1 = nconv(spade_ic, ndf, 3, 1)
        self.layer2 = nconv(ndf, ndf * 2, ak, 2)
        self.layer3 = nconv(ndf * 2, ndf * 4, 3, 1)
        if opt.warp_stride == 2:
            self.layer4 = nconv(ndf * 4, ndf * 8, 3, 1)
        else:
            self.layer4 = nconv(ndf * 4, ndf * 8, ak, 2)
        self.layer5 = nconv(ndf * 8, ndf * 8, 3, 1)
        self.head_0 = block(8 * nf, 8 * nf)
        self.G_middle_0 = block(8 * nf, 8 * nf)
        self.G_middle_1 = block(8 * nf, 4 * nf)

    def forward(self, x, seg: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, spade_ic) tensor or OneHotLabels; seg: the dense
        conditioning map."""
        x = _to_compute(x)
        seg = _to_compute(seg)
        h = self.layer1(x)
        h = self.layer2(leaky_relu(h))
        h = self.layer3(leaky_relu(h))
        h = self.layer4(leaky_relu(h))
        h = self.layer5(leaky_relu(h))
        h = self.head_0(h, seg)
        h = self.G_middle_0(h, seg)
        return self.G_middle_1(h, seg)
