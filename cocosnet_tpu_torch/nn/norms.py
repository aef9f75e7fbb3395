"""Normalization layers: instance norm, positional norm (PONO), synchronized
batch norm and SPADE, plus NormConv (a conv with its weight norm and
parameter-free norm).

Counterpart of cocosnet_tpu/nn/norms.py, on NHWC tensors. Parity notes:
- InstanceNorm2d: biased variance, eps 1e-5, affine=False.
- PositionalNorm2d: channel mean and *unbiased* variance (torch x.var()).
- BatchNorm (norms.py:68-105): in train mode the batch moments in f32,
  biased variance to normalize, the unbiased one into the running
  variance, momentum 0.1; in eval mode the running statistics; output in
  the input's dtype; affine weight and bias start at 1 and 0. Across data
  ranks the moments are the global batch's (SynchronizedBatchNorm2d,
  mesh.data_sum_grad); the ranks of a model group hold the same whole maps,
  so they are not reduced there.
- SPADE: parameter-free norm, then gamma/beta from a 128-hidden
  reflection-padded conv MLP over the nearest-resized conditioning map;
  out = x_hat * (1 + gamma) + beta.
"""

from __future__ import annotations

import re

import torch
import torch.nn as tnn

from cocosnet_tpu_torch import mesh as M
from cocosnet_tpu_torch.nn import remat
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


class BatchNorm(tnn.Module):
    """Synchronized batch norm over every dim but the last (NHWC maps, or
    (N, C) features), with the reference's buffer names: running_mean,
    running_var, num_batches_tracked, and with `affine` weight and bias."""

    def __init__(self, features: int, affine: bool = True,
                 eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        if affine:
            self.weight = tnn.Parameter(torch.ones(features))
            self.bias = tnn.Parameter(torch.zeros(features))
        else:
            self.weight = self.bias = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()
            if self.weight is not None:
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # under the bf16 policy the moments stay f32 and the output takes
        # x's dtype (norms.py:92-100)
        x32 = x.float()
        if self.training:
            mean, var, n = _global_moments(x32)
            # a recompute (nn/remat.py) leaves the statistics where the
            # first run put them
            if not remat.replaying():
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var.detach() * (n / max(n - 1, 1))
                    self.running_mean.mul_(1 - m).add_(m * mean.detach())
                    self.running_var.mul_(1 - m).add_(m * unbiased)
                    self.num_batches_tracked.add_(1)
        else:
            # device buffers only, no host read: an eval forward captures
            # into the serving CUDA graph (tools/serve.make_serve_step)
            mean, var = self.running_mean, self.running_var
        y = ((x32 - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        if self.weight is not None:
            y = y * self.weight.to(y.dtype) + self.bias.to(y.dtype)
        return y


def _global_moments(x32: torch.Tensor):
    """(mean, biased var, count) over every dim but the last, of the
    global batch: across data ranks two differentiable sums, the mean's,
    then the squared deviations' (mesh.data_sum_grad)."""
    dims = tuple(range(x32.dim() - 1))
    local = x32.numel() // x32.shape[-1]
    mesh = M.global_mesh()
    if mesh.data_group is None:
        return (x32.mean(dim=dims), x32.var(dim=dims, unbiased=False),
                local)
    n = local * mesh.data
    mean = M.data_sum_grad(x32.sum(dim=dims)) / n
    var = M.data_sum_grad(((x32 - mean) ** 2).sum(dim=dims)) / n
    return mean, var, n


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
        self.pono = pono
        self.param_free_norm = None
        if not pono and norm_type in ("syncbatch", "batch"):
            self.param_free_norm = BatchNorm(norm_nc, affine=False)
        elif not pono and norm_type != "instance":
            raise ValueError(
                f"unrecognized SPADE param-free norm {norm_type!r}")
        nhidden = 128
        # index 0 stands for the reference's ReflectionPad2d, which the
        # conv applies itself; the conv keeps the name mlp_shared.1
        self.mlp_shared = tnn.Sequential(
            tnn.Identity(),
            Conv2d(label_nc, nhidden, ks, reflect_pad=True), tnn.ReLU())
        self.mlp_gamma = Conv2d(nhidden, norm_nc, ks, reflect_pad=True)
        self.mlp_beta = Conv2d(nhidden, norm_nc, ks, reflect_pad=True)

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        if self.pono:
            normalized = positional_norm(x)
        elif self.param_free_norm is not None:
            normalized = self.param_free_norm(x)
        else:
            normalized = instance_norm(x)
        seg = resize_nearest(segmap, x.shape[1], x.shape[2])
        actv = self.mlp_shared(seg)
        gamma = self.mlp_gamma(actv)
        beta = self.mlp_beta(actv)
        return normalized.to(gamma.dtype) * (1 + gamma) + beta


class NormConv(tnn.Module):
    """A conv wrapped with optional spectral/equal-lr weight norm and a
    parameter-free norm; the conv bias is dropped when a norm follows. The
    conv is child "0" and a batch norm child "1", as in the reference's
    Sequential. norm_str: 'spectralinstance', 'instance',
    'spectralsync_batch', 'batch', 'spectral', 'none', ..."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 norm_str: str = "spectralinstance", *, stride: int = 1,
                 padding: int = 0, dilation: int = 1, eqlr_sn: bool = False):
        super().__init__()
        weight_norm = None
        if norm_str.startswith("spectral"):
            weight_norm = "equal_lr" if eqlr_sn else "spectral"
            norm_str = norm_str[len("spectral"):]
        if norm_str not in ("", "none", "instance", "batch", "sync_batch"):
            raise ValueError(
                f"normalization layer {norm_str!r} is not recognized")
        self.instance = norm_str == "instance"
        self.add_module("0", Conv2d(
            cin, features, kernel_size, stride=stride, padding=padding,
            dilation=dilation, use_bias=norm_str in ("", "none"),
            weight_norm=weight_norm))
        if norm_str in ("batch", "sync_batch"):
            self.add_module("1", BatchNorm(features, affine=True))

    def forward(self, x) -> torch.Tensor:
        conv = self._modules["0"]
        if self.instance:
            y, mean, var = conv(x, want_stats=True)
            return instance_norm_apply(y, mean, var)
        y = conv(x)
        norm = self._modules.get("1")
        return y if norm is None else norm(y)
