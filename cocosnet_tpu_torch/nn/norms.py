"""Normalization layers: instance norm, positional norm (PONO) and SPADE,
plus NormConv (a conv with its weight norm and parameter-free norm).

Counterpart of cocosnet_tpu/nn/norms.py, on NHWC tensors. Parity notes:
- InstanceNorm2d: biased variance, eps 1e-5, affine=False.
- PositionalNorm2d: channel mean and *unbiased* variance (torch x.var()).
- SPADE: parameter-free norm, then gamma/beta from a 128-hidden
  reflection-padded conv MLP over the nearest-resized conditioning map;
  out = x_hat * (1 + gamma) + beta.
BatchNorm is not ported yet: on the flagship PONO replaces it.
"""

from __future__ import annotations

import re

import torch
import torch.nn as tnn

from cocosnet_tpu_torch.nn.layers import Conv2d
from cocosnet_tpu_torch.ops.image import resize_nearest


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """nn.InstanceNorm2d(affine=False) on NHWC; statistics in f32, output
    in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = x32.var(dim=(1, 2), unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def instance_norm_apply(x: torch.Tensor, mean: torch.Tensor,
                        var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """instance_norm with moments computed beforehand (by the conv)."""
    return ((x.float() - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def positional_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """PONO: normalize over the channel dim at each position, unbiased
    variance; statistics in f32, output in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=x.shape[-1] > 1, keepdim=True)
    return ((x32 - mean) / torch.sqrt(var + eps)).to(x.dtype)


def parse_spade_config(config_text: str):
    """spade(norm)(ks) -> (param-free norm type, kernel size)."""
    m = re.search(r"spade(\D+)(\d)x\d", config_text)
    return str(m.group(1)), int(m.group(2))


class SPADE(tnn.Module):
    """Spatially-adaptive denormalization. norm_nc: channels of x;
    label_nc: channels of the conditioning map."""

    def __init__(self, config_text: str, norm_nc: int, label_nc: int,
                 pono: bool = False):
        super().__init__()
        norm_type, ks = parse_spade_config(config_text)
        if not pono and norm_type != "instance":
            raise NotImplementedError(
                f"SPADE param-free norm {norm_type!r} is not ported; the "
                "port runs PONO or instance norm")
        self.pono = pono
        nhidden = 128
        # index 0 stands for the reference's ReflectionPad2d, which the
        # conv applies itself; the conv keeps the name mlp_shared.1
        self.mlp_shared = tnn.Sequential(
            tnn.Identity(),
            Conv2d(label_nc, nhidden, ks, reflect_pad=True), tnn.ReLU())
        self.mlp_gamma = Conv2d(nhidden, norm_nc, ks, reflect_pad=True)
        self.mlp_beta = Conv2d(nhidden, norm_nc, ks, reflect_pad=True)

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        normalized = positional_norm(x) if self.pono else instance_norm(x)
        seg = resize_nearest(segmap, x.shape[1], x.shape[2])
        actv = self.mlp_shared(seg)
        gamma = self.mlp_gamma(actv)
        beta = self.mlp_beta(actv)
        return normalized.to(gamma.dtype) * (1 + gamma) + beta


class NormConv(tnn.Module):
    """A conv wrapped with optional spectral/equal-lr weight norm and a
    parameter-free instance norm; the conv bias is dropped when a norm
    follows. The conv is child "0", as in the reference's Sequential.
    norm_str: 'spectralinstance', 'instance', 'spectral' or 'none'."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 norm_str: str = "spectralinstance", *, stride: int = 1,
                 padding: int = 0, eqlr_sn: bool = False):
        super().__init__()
        weight_norm = None
        if norm_str.startswith("spectral"):
            weight_norm = "equal_lr" if eqlr_sn else "spectral"
            norm_str = norm_str[len("spectral"):]
        if norm_str not in ("", "none", "instance"):
            raise NotImplementedError(
                f"normalization layer {norm_str!r} is not ported")
        self.instance = norm_str == "instance"
        self.add_module("0", Conv2d(
            cin, features, kernel_size, stride=stride, padding=padding,
            use_bias=not self.instance,
            weight_norm=weight_norm))

    def forward(self, x) -> torch.Tensor:
        conv = self._modules["0"]
        if not self.instance:
            return conv(x)
        y, mean, var = conv(x, want_stats=True)
        return instance_norm_apply(y, mean, var)
