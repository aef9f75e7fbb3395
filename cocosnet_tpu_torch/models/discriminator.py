"""Multiscale PatchGAN discriminator.

Counterpart of cocosnet_tpu/models/discriminator.py with the reference's
state-dict names (discriminator.py:16-177): per scale `model0` (4x4
stride-2 conv, LeakyReLU), `model1`..`model{n-1}` (spectral-instance 4x4
convs, stride 1 on the last, LeakyReLU), `attn` (SAGAN attention before the
last of them, with --use_attention) and `model{n}` (4x4 conv to one logit
map). The input is downsampled between scales with avg_pool(3, 2, pad 1,
count_include_pad=False). D_cam is not ported.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as tnn

from cocosnet_tpu_torch.config import Options
from cocosnet_tpu_torch.nn.blocks import Attention
from cocosnet_tpu_torch.nn.layers import Conv2d
from cocosnet_tpu_torch.nn.norms import NormConv
from cocosnet_tpu_torch.ops.image import avg_pool_3x3_s2_p1


class NLayerDiscriminator(tnn.Module):
    def __init__(self, opt: Options, input_nc: int):
        super().__init__()
        self.opt = opt
        kw, padw = 4, 1
        nf = opt.ndf
        self.model0 = tnn.Sequential(
            Conv2d(input_nc, nf, kw, stride=2, padding=padw),
            tnn.LeakyReLU(0.2))
        self.use_attention = opt.use_attention
        for n in range(1, opt.n_layers_D):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == opt.n_layers_D - 1 else 2
            if opt.use_attention and n == opt.n_layers_D - 1:
                self.attn = Attention(nf_prev, "spectral" in opt.norm_D)
            self.add_module(f"model{n}", tnn.Sequential(
                NormConv(nf_prev, nf, kw, opt.norm_D, stride=stride,
                         padding=padw, eqlr_sn=opt.eqlr_sn),
                tnn.LeakyReLU(0.2)))
        self.add_module(f"model{opt.n_layers_D}", tnn.Sequential(
            Conv2d(nf, 1, kw, stride=1, padding=padw)))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The features of every layer, the patch logit map last."""
        n_layers = self.opt.n_layers_D
        # three stride-2 convs precede the last 4x4 conv: anything smaller
        # bottoms out at empty patch maps
        if min(x.shape[1], x.shape[2]) < 4 * 2 ** (n_layers - 1):
            raise ValueError(f"discriminator input {tuple(x.shape)} too "
                             f"small for n_layers_D={n_layers}")
        results = [self.model0(x)]
        for n in range(1, n_layers):
            h = results[-1]
            if self.use_attention and n == n_layers - 1:
                h = self.attn(h)
            results.append(self._modules[f"model{n}"](h))
        results.append(self._modules[f"model{n_layers}"](results[-1]))
        return results


class MultiscaleDiscriminator(tnn.Module):
    def __init__(self, opt: Options):
        super().__init__()
        input_nc = opt.semantic_nc + 3
        for i in range(opt.num_D):
            self.add_module(f"discriminator_{i}",
                            NLayerDiscriminator(opt, input_nc))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        results = []
        for d in self.children():
            results.append(d(x))
            x = avg_pool_3x3_s2_p1(x)
        return results
