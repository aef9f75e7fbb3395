"""Composite blocks: the SPADE resblock, SAGAN self-attention, the SE layer
and the correspondence residual block.

Counterpart of cocosnet_tpu/nn/blocks.py (SPADEResnetBlock, Attention,
SELayer, ResidualBlock), on NHWC tensors with the reference's state-dict
names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as tnn

from cocosnet_tpu_torch.nn import remat
from cocosnet_tpu_torch.nn.layers import Conv2d, Linear, PReLU, leaky_relu
from cocosnet_tpu_torch.nn.norms import SPADE, instance_norm_apply
from cocosnet_tpu_torch.ops.image import max_pool, resize_nearest


class SPADEResnetBlock(tnn.Module):
    """Reflection-padded 3x3 convs (dilated by `dilation`), a
    SPADE-normalized learned shortcut when fin != fout, LeakyReLU(0.2),
    and with use_se an SE layer on the residual. spade_ic is the
    conditioning map's channel count. With remat_policy (--remat), a
    train-mode forward that records a gradient keeps only what the policy
    says and re-runs the block in the backward (nn/remat.py)."""

    def __init__(self, fin: int, fout: int, spade_config: str,
                 spade_ic: int, *, use_spectral: bool = True,
                 eqlr_sn: bool = False, pono: bool = False,
                 use_se: bool = False, dilation: int = 1,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.remat_policy = remat_policy
        fmiddle = min(fin, fout)
        wn = None
        if use_spectral:
            wn = "equal_lr" if eqlr_sn else "spectral"
        self.learned_shortcut = fin != fout
        if self.learned_shortcut:
            self.norm_s = SPADE(spade_config, fin, spade_ic, pono=pono)
            self.conv_s = Conv2d(fin, fout, 1, use_bias=False,
                                 weight_norm=wn)
        self.norm_0 = SPADE(spade_config, fin, spade_ic, pono=pono)
        self.conv_0 = Conv2d(fin, fmiddle, 3, dilation=dilation,
                             weight_norm=wn, reflect_pad=True)
        self.norm_1 = SPADE(spade_config, fmiddle, spade_ic, pono=pono)
        self.conv_1 = Conv2d(fmiddle, fout, 3, dilation=dilation,
                             weight_norm=wn, reflect_pad=True)
        # the JAX package's (and the reference's) misspelt name
        self.se_layar = SELayer(fout) if use_se else None

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        if self.remat_policy is not None and self.training:
            return remat.checkpoint(self._forward, x, seg,
                                    policy=self.remat_policy)
        return self._forward(x, seg)

    def _forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        # every SPADE norm here runs at x's size: resize the map once
        seg = resize_nearest(seg, x.shape[1], x.shape[2])
        if self.learned_shortcut:
            x_s = self.conv_s(self.norm_s(x, seg))
        else:
            x_s = x
        dx = self.conv_0(leaky_relu(self.norm_0(x, seg)))
        dx = self.conv_1(leaky_relu(self.norm_1(dx, seg)))
        if self.se_layar is not None:
            dx = self.se_layar(dx)
        return x_s + dx


class Attention(tnn.Module):
    """SAGAN self-attention: theta/phi/g 1x1 convs, phi and g max-pooled
    2x2, a learnable gate gamma initialized to 0. The two products and the
    softmax are plain torch.matmul/softmax in f32."""

    def __init__(self, ch: int, use_sn: bool):
        super().__init__()
        wn = "spectral" if use_sn else None
        self.theta = Conv2d(ch, ch // 8, 1, use_bias=False, weight_norm=wn)
        self.phi = Conv2d(ch, ch // 8, 1, use_bias=False, weight_norm=wn)
        self.g = Conv2d(ch, ch // 2, 1, use_bias=False, weight_norm=wn)
        self.o = Conv2d(ch // 2, ch, 1, use_bias=False, weight_norm=wn)
        self.gamma = tnn.Parameter(torch.empty(1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        theta = self.theta(x).reshape(n, h * w, c // 8)
        phi = max_pool(self.phi(x), 2).reshape(n, h * w // 4, c // 8)
        g = max_pool(self.g(x), 2).reshape(n, h * w // 4, c // 2)
        beta = torch.softmax(
            torch.matmul(theta.float(), phi.float().transpose(1, 2)), dim=-1)
        o = torch.matmul(beta.to(g.dtype).float(), g.float()).to(x.dtype)
        o = self.o(o.reshape(n, h, w, c // 2))
        return self.gamma.to(x.dtype) * o.to(x.dtype) + x


class SELayer(tnn.Module):
    """Squeeze-excitation: the channel means through two bias-free f32
    dense layers (fc_0, fc_1), ReLU between, a sigmoid gate on x."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc_0 = Linear(channel, channel // reduction, use_bias=False)
        self.fc_1 = Linear(channel // reduction, channel, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float().mean(dim=(1, 2))
        y = torch.sigmoid(self.fc_1(torch.relu(self.fc_0(y))))
        return x * y[:, None, None, :].to(x.dtype)


class ResidualBlock(tnn.Module):
    """Correspondence residual block: reflect-padded conv, instance norm,
    PReLU, twice, plus the skip, then PReLU. The instance-norm moments come
    out of the conv (conv2d want_stats)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3, reflect_pad=True)
        self.conv2 = Conv2d(channels, channels, 3, reflect_pad=True)
        self.prelu = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, mean, var = self.conv1(x, want_stats=True)
        out = self.prelu(instance_norm_apply(out, mean, var))
        out, mean, var = self.conv2(out, want_stats=True)
        return self.prelu(instance_norm_apply(out, mean, var) + x)
