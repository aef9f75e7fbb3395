"""Convolutions with torch padding semantics on NHWC tensors, the dispatch to
the hand-written 3x3 kernels, spectral-norm / equalized-LR weights, PReLU.

Counterpart of cocosnet_tpu/nn/layers.py. Activations are NHWC, conv
kernels HWIO at `conv2d`, parameters f32 in the reference's state-dict
names and OIHW shapes (`weight`, `bias`; `weight_orig`, `weight_u`,
`weight_v` under spectral norm). Spectral norm follows
torch.nn.utils.spectral_norm: a module in train mode advances one power
iteration per forward and stores u and v; in eval mode sigma = u . (W v)
comes from the stored u and v, unchanged. Inside a recomputed region
(nn/remat.py) the recompute reads back the u and v of the first run.
A dilated conv runs on the library, as the JAX package's gates send it to
XLA (layers.py:132, :181).

Inside `training()` the convs route as the JAX package's training trace
routes them (pallas_conv.training_trace): by default every conv is a
library conv; COCOSNET_FUSED_CONV_TRAIN=1 sends the fused kernel's shapes
to conv3x3_fused and its backward, COCOSNET_PALLAS_DW=1 or =all sends the
3x3 convs of its gate to conv3x3_xla_pdw (library forward and dx, dW on
csrc/conv3x3_dw.cu). The statistics and one-hot kernels stay inference
only.

Every gate reads the JAX package's switches at each call, where it reads
them (pallas_conv.py:600, :664, :795): FUSED_ENV ("0" or "false" turns off
the fused conv and the statistics conv), FUSED_STATS_ENV (the statistics
conv) and ONEHOT_ENV (the one-hot conv). A switch that is off sends a CUDA
tensor to the library route, the reference's own route; unset, each is on.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.nn as tnn
import torch.nn.functional as F

from cocosnet_tpu_torch.nn import remat
from cocosnet_tpu_torch.ops.conv3x3 import (conv3x3_dw_supported,
                                            conv3x3_fused,
                                            conv3x3_fused_stats,
                                            conv3x3_onehot, conv3x3_xla_pdw)
from cocosnet_tpu_torch.ops.ring import reflect_ring

# "1" (or "true") lets training convs take conv3x3_fused where its gate
# agrees; anything else keeps them off it
FUSED_TRAIN_ENV = "COCOSNET_FUSED_CONV_TRAIN"
# "0" or "false" turns a kernel off (default on), as in the JAX package
FUSED_ENV = "COCOSNET_FUSED_CONV"
FUSED_STATS_ENV = "COCOSNET_FUSED_CONV_STATS"
ONEHOT_ENV = "COCOSNET_ONEHOT_CONV"

# Compute-dtype policy for convolutions: None = f32; torch.bfloat16 runs
# operands and outputs in bf16 with f32 accumulation inside the conv.
_COMPUTE_DTYPE = None


def set_compute_dtype(dtype) -> None:
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype


def get_compute_dtype():
    return _COMPUTE_DTYPE


_IN_TRAINING = False


@contextlib.contextmanager
def training():
    """The dynamic extent of a train step: `conv2d` routes as the JAX
    training trace does (a OneHotLabels input densified, instance-norm
    moments from torch on the conv output, the conv itself on the library
    unless FUSED_TRAIN_ENV or the DW_ENV of ops/conv3x3 say otherwise)."""
    global _IN_TRAINING
    prev = _IN_TRAINING
    _IN_TRAINING = True
    try:
        yield
    finally:
        _IN_TRAINING = prev


class OneHotLabels:
    """Lazy one_hot(labels, n_classes) standing in for a dense (B, H, W, C)
    activation, so `conv2d` can route the seg adaptor's first conv to the
    one-hot kernel, which reads the label map instead of the one-hot."""

    def __init__(self, labels: torch.Tensor, n_classes: int,
                 dtype=torch.float32):
        self.labels = labels          # (B, H, W) int
        self.n_classes = n_classes
        self.dtype = dtype

    @property
    def shape(self):
        b, h, w = self.labels.shape
        return (b, h, w, self.n_classes)

    @property
    def ndim(self):
        return 4

    def to(self, dtype) -> "OneHotLabels":
        return OneHotLabels(self.labels, self.n_classes, dtype)

    def dense(self) -> torch.Tensor:
        classes = torch.arange(self.n_classes, device=self.labels.device)
        return (self.labels[..., None] == classes).to(self.dtype)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _base_supported(x_shape, kernel_shape, *, stride: int,
                    padding: int) -> bool:
    """pallas_conv._base_supported less its TPU-only conditions (the TPU
    check and the VMEM tile search of both orientations, which have no H100
    meaning): FUSED_ENV not off, 3x3, stride 1, padding 1 (a reflect ring
    counts as padding 1), and its size conditions."""
    if os.environ.get(FUSED_ENV, "1") in ("0", "false"):
        return False
    if len(x_shape) != 4 or tuple(kernel_shape[:2]) != (3, 3):
        return False
    if stride != 1 or padding != 1:
        return False
    _, h, w, c = x_shape
    cout = kernel_shape[3]
    return (w % 16 == 0 and w >= 32 and h >= 8 and h * w >= 2048
            and c >= 64 and cout >= 64)


def conv3x3_supported(x_shape, kernel_shape, *, stride: int,
                      padding: int) -> bool:
    """The gate of conv3x3_fused (pallas_conv.conv3x3_supported): off
    inside training() unless FUSED_TRAIN_ENV is "1" or "true" (read at each
    call), the base conditions, and not where both channel counts are at
    least 256 and rounding them up to 128 lanes would grow the GEMM more
    than 1.5x (pallas_conv.py:642-649: the 407-channel residual stack)."""
    if _IN_TRAINING and os.environ.get(FUSED_TRAIN_ENV, "0") not in (
            "1", "true"):
        return False
    if not _base_supported(x_shape, kernel_shape, stride=stride,
                           padding=padding):
        return False
    c, cout = x_shape[3], kernel_shape[3]
    pad_ratio = (_round_up(c, 128) / c) * (_round_up(cout, 128) / cout)
    return not (pad_ratio > 1.5 and min(c, cout) >= 256)


def conv3x3_stats_supported(x_shape, kernel_shape, *, stride: int,
                            padding: int) -> bool:
    """The gate of conv3x3_fused_stats (pallas_conv.conv3x3_stats_
    supported): inference only (no backward), FUSED_STATS_ENV not off, the
    base conditions, the heavy pad-ratio shapes included."""
    if _IN_TRAINING or os.environ.get(FUSED_STATS_ENV, "1") in ("0",
                                                                 "false"):
        return False
    return _base_supported(x_shape, kernel_shape, stride=stride,
                           padding=padding)


def conv3x3_onehot_supported(lab_shape, n_classes: int, cout: int) -> bool:
    """The gate of conv3x3_onehot (pallas_conv.conv3x3_onehot_supported)
    less its TPU-only conditions (the TPU check and the VMEM tile search):
    ONEHOT_ENV not off, inference only (no backward), a (B, H, W) label
    map with W % 128 == 0, H >= 8, H W >= 2048, and Cout >= 64. Any class
    count: the kernel gathers weight rows by label."""
    del n_classes
    if os.environ.get(ONEHOT_ENV, "1") in ("0", "false"):
        return False
    if _IN_TRAINING or len(lab_shape) != 3:
        return False
    _, h, w = lab_shape
    return w % 128 == 0 and h >= 8 and h * w >= 2048 and cout >= 64


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(x, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           reflect: bool = False, want_stats: bool = False):
    """torch F.conv2d semantics on an NHWC input and an HWIO kernel;
    reflect=True applies a ReflectionPad2d ring of dilation * (k-1)/2
    first.
    Under the bf16 policy operands and output are bf16, accumulation f32.
    With want_stats returns (y, mean, var): the instance-norm moments of y,
    f32 (B, 1, 1, Cout), biased variance.

    Routing, in the JAX package's order (cocosnet_tpu/nn/layers.py:
    129-203): a OneHotLabels input of a 3x3 stride-1 zero-padded conv goes
    to conv3x3_onehot where `conv3x3_onehot_supported`, else it is
    densified; a stats request to conv3x3_fused_stats where
    `conv3x3_stats_supported`, else to the conv below and torch moments;
    then conv3x3_fused where `conv3x3_supported`; inside `training()`, a
    3x3 stride-1 conv (reflect or padding 1) of the dW gate to
    conv3x3_xla_pdw; everything else to F.conv2d, its reflect ring built in
    NHWC by ops/ring.reflect_ring and its operands channels-last."""
    weight = kernel
    if _COMPUTE_DTYPE is not None:
        x = x.to(_COMPUTE_DTYPE)
        kernel = kernel.to(_COMPUTE_DTYPE)
    if reflect and (padding != 0 or stride != 1):
        raise ValueError("a reflect ring takes padding=0 and stride=1")
    if isinstance(x, OneHotLabels):
        if (tuple(kernel.shape[:2]) == (3, 3) and stride == 1
                and dilation == 1 and padding == 1 and not reflect
                and conv3x3_onehot_supported(x.labels.shape, x.n_classes,
                                             kernel.shape[3])):
            return conv3x3_onehot(x.labels, kernel, bias, dtype=x.dtype,
                                  want_stats=want_stats)
        return conv2d(x.dense(), weight, bias, stride=stride,
                      padding=padding, dilation=dilation, reflect=reflect,
                      want_stats=want_stats)
    gate = dict(stride=stride, padding=1 if reflect else padding)
    kernels = dilation == 1     # no kernel takes a dilated conv
    if want_stats and kernels and conv3x3_stats_supported(
            x.shape, kernel.shape, **gate):
        return conv3x3_fused_stats(x, kernel, bias, reflect=reflect)
    if want_stats:
        y = conv2d(x, weight, bias, stride=stride, padding=padding,
                   dilation=dilation, reflect=reflect)
        y32 = y.float()
        mean = y32.mean(dim=(1, 2), keepdim=True)
        var = y32.var(dim=(1, 2), unbiased=False, keepdim=True)
        return y, mean, var
    if kernels and conv3x3_supported(x.shape, kernel.shape, **gate):
        return conv3x3_fused(x, kernel, bias, reflect=reflect)
    if (_IN_TRAINING and kernels and tuple(kernel.shape[:2]) == (3, 3)
            and stride == 1 and (reflect or padding == 1)
            and conv3x3_dw_supported(x.shape, kernel.shape,
                                     reflect=reflect)):
        # the weight as the caller holds it: its dW arrives in f32
        return conv3x3_xla_pdw(x, weight, bias, reflect)
    xc = _nchw(x)
    if reflect:
        p = dilation * (kernel.shape[0] - 1) // 2
        xc = _nchw(reflect_ring(x, p)) if p else xc
    # the ring built in NHWC and the weight channels-last: cuDNN takes both
    # as they are (an input that is not NHWC-contiguous is copied to it) and
    # returns a channels-last y, with no layout transform either way. A
    # conv of one output channel (the discriminator's last) still gets one:
    # its y's layout is ambiguous. The non-reflect convs, whose input was
    # channels-last already, share the weight line and gain nothing by it
    w = kernel.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    y = F.conv2d(xc, w, None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=padding, dilation=dilation)
    return _nhwc(y)


# xavier-normal gain of every conv (the reference's --init_variance 0.02)
INIT_GAIN = 0.02


def xavier_normal_(w: torch.Tensor, gain: float,
                   generator: torch.Generator) -> None:
    """torch.nn.init.xavier_normal_ drawn from `generator`."""
    fan_out, fan_in = w.shape[0], w.shape[1]
    if w.dim() == 4:
        fan_in *= w.shape[2] * w.shape[3]
        fan_out *= w.shape[2] * w.shape[3]
    std = gain * (2.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator) * std)


def _l2_normalize(v: torch.Tensor) -> torch.Tensor:
    """v / (||v|| + 1e-12), the JAX package's _l2_normalize."""
    return v / (v.norm() + 1e-12)


def _unit_normal(n: int, generator: torch.Generator) -> torch.Tensor:
    return _l2_normalize(torch.randn(n, generator=generator))


def _init_weight(mod: tnn.Module, shape, weight_norm: Optional[str]) -> None:
    """`weight`, or under a weight norm `weight_orig` (and the spectral
    `weight_u`, `weight_v` buffers), as torch's spectral_norm names them."""
    if weight_norm not in (None, "spectral", "equal_lr"):
        raise ValueError(f"unknown weight_norm {weight_norm!r}")
    mod.weight_norm = weight_norm
    w = tnn.Parameter(torch.empty(*shape))
    if weight_norm is None:
        mod.weight = w
        return
    mod.weight_orig = w
    if weight_norm == "spectral":
        mod.register_buffer("weight_u", torch.empty(shape[0]))
        mod.register_buffer("weight_v", torch.empty(w[0].numel()))


def _reset_weight(mod: tnn.Module, generator: torch.Generator) -> None:
    w = mod.weight if mod.weight_norm is None else mod.weight_orig
    xavier_normal_(w, INIT_GAIN, generator)
    with torch.no_grad():
        if mod.bias is not None:
            mod.bias.zero_()
        if mod.weight_norm == "spectral":
            mod.weight_u.copy_(_unit_normal(w.shape[0], generator))
            mod.weight_v.copy_(_unit_normal(w[0].numel(), generator))


def _effective_weight(mod: tnn.Module) -> torch.Tensor:
    """The weight the layer applies. Under spectral norm in train mode one
    power iteration, v = normalize(W^T u), u = normalize(W v), runs first
    and stores u and v (without gradient, as in torch); a recompute
    (nn/remat.py) reads back the u and v its first run used instead of
    advancing them again."""
    if mod.weight_norm is None:
        return mod.weight
    w = mod.weight_orig
    if mod.weight_norm == "equal_lr":
        return w * (2.0 / w[0].numel()) ** 0.5
    wm = w.reshape(w.shape[0], -1)
    u, v = mod.weight_u, mod.weight_v
    if mod.training:
        def power_iteration():
            with torch.no_grad():
                v = _l2_normalize(wm.t() @ mod.weight_u)
                u = _l2_normalize(wm @ v)
                mod.weight_u.copy_(u)
                mod.weight_v.copy_(v)
            return u, v
        u, v = remat.stateful(power_iteration)
    return w / torch.dot(u, wm @ v)


class Conv2d(tnn.Module):
    """Conv with torch-style symmetric zero padding, or with reflect_pad a
    ReflectionPad2d ring that the conv applies itself (so the 3x3 kernel
    builds the ring on chip instead of reading a padded copy).

    weight_norm: None | 'spectral' | 'equal_lr'. use_bias=False mirrors the
    reference deleting the conv bias where a parameter-free norm follows.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, *,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 use_bias: bool = True, weight_norm: Optional[str] = None,
                 reflect_pad: bool = False):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.reflect_pad = reflect_pad
        k = kernel_size
        _init_weight(self, (cout, cin, k, k), weight_norm)
        self.bias = tnn.Parameter(torch.empty(cout)) if use_bias else None

    reset_parameters = _reset_weight
    effective_weight = _effective_weight

    def forward(self, x, want_stats: bool = False):
        return conv2d(x, self.effective_weight().permute(2, 3, 1, 0),
                      self.bias, stride=self.stride, padding=self.padding,
                      dilation=self.dilation, reflect=self.reflect_pad,
                      want_stats=want_stats)


class Linear(tnn.Module):
    """The JAX package's Dense on the last dim, in f32: weight (out, in),
    xavier-normal at gain 0.02, zero bias, optional spectral or
    equal-lr weight norm (the CAM discriminator's gap_fc / gmp_fc)."""

    def __init__(self, cin: int, cout: int, *, use_bias: bool = True,
                 weight_norm: Optional[str] = None):
        super().__init__()
        _init_weight(self, (cout, cin), weight_norm)
        self.bias = tnn.Parameter(torch.empty(cout)) if use_bias else None

    reset_parameters = _reset_weight
    effective_weight = _effective_weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.float(), self.effective_weight().t())
        return y if self.bias is None else y + self.bias


class PReLU(tnn.Module):
    """nn.PReLU with one shared slope, init 0.25."""

    def __init__(self):
        super().__init__()
        self.weight = tnn.Parameter(torch.empty(1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def init_weights(module: tnn.Module, generator: torch.Generator) -> None:
    """Seeded init of every parameter and spectral vector of `module`, in
    module order, from one explicit generator: each of the port's modules
    that owns parameters directly has reset_parameters(generator)."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)


def condition_weights(module: tnn.Module, g: torch.Generator, dev) -> None:
    """Random weights at unit signal scale from generator g: conv weights
    at 1/sqrt(fan_in), biases at 0.1, PReLU 0.2, attention gate 0.5, and
    spectral u/v set to the leading singular vectors by power iteration,
    so sigma is the spectral norm (the init leaves u/v random, sigma near
    0 and the activations far from unit scale)."""
    from cocosnet_tpu_torch.nn.blocks import Attention
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv2d):
                w = m.weight if m.weight_norm is None else m.weight_orig
                w.copy_((torch.randn(w.shape, generator=g)
                         * w[0].numel() ** -0.5).to(dev))
                if m.bias is not None:
                    m.bias.copy_((torch.randn(m.bias.shape, generator=g)
                                  * 0.1).to(dev))
                if m.weight_norm == "spectral":
                    wm = w.reshape(w.shape[0], -1)
                    u = m.weight_u
                    for _ in range(50):
                        v = F.normalize(wm.t() @ u, dim=0)
                        u = F.normalize(wm @ v, dim=0)
                    m.weight_u.copy_(u)
                    m.weight_v.copy_(v)
            elif isinstance(m, PReLU):
                m.weight.fill_(0.2)
            elif isinstance(m, Attention):
                m.gamma.fill_(0.5)
