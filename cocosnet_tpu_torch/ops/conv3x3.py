"""Fused 3x3 stride-1 convolutions: dense (with a statistics variant) and
one-hot input.

Counterpart of cocosnet_tpu/ops/pallas_conv.py `conv3x3_fused`,
`conv3x3_fused_stats` and `conv3x3_onehot`, with the JAX package's layout:
NHWC activations, HWIO kernels, f32 bias, output in the activation dtype,
f32 accumulation. On a CUDA tensor each wrapper launches its hand-written
kernel (csrc/conv3x3.cu, csrc/conv3x3_onehot.cu) and counts the launch; on
a CPU tensor it runs the plain PyTorch version of the same function. The
kernels have no backward, so a CUDA input that requires grad raises.

The statistics are the kernel's: per-(sample, channel) mean and biased
variance of the f32 output before rounding, the variance single-pass,
E[x^2] - E[x]^2 clamped at 0 (pallas_conv.py:692-701).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cocosnet_tpu_torch.ops import _build

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _moments(sums: torch.Tensor, n: int):
    """(B, 2, Cout) sum/sumsq -> mean, var (B, 1, 1, Cout), single pass."""
    mean = sums[:, 0] / n
    var = torch.clamp(sums[:, 1] / n - mean * mean, min=0.0)
    return mean[:, None, None, :], var[:, None, None, :]


def _epilogue_plain(y: torch.Tensor, bias, leaky, dtype, want_stats):
    """y: f32 NCHW conv output -> NHWC output (+ moments) like the kernels."""
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    if leaky is not None:
        y = torch.where(y >= 0, y, leaky * y)
    out = y.permute(0, 2, 3, 1).to(dtype).contiguous()
    if not want_stats:
        return out
    sums = torch.stack([y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))], 1)
    return (out,) + _moments(sums, y.shape[2] * y.shape[3])


def conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor], *, reflect: bool = False,
                  leaky: Optional[float] = None, want_stats: bool = False):
    """Plain version of the dense kernel: an f32 convolution of the operands
    as rounded to x's dtype, bias and LeakyReLU in f32, one rounding."""
    w = kernel.to(x.dtype).float().permute(3, 2, 0, 1)
    xf = x.float().permute(0, 3, 1, 2)
    if reflect:
        y = F.conv2d(F.pad(xf, (1, 1, 1, 1), mode="reflect"), w)
    else:
        y = F.conv2d(xf, w, padding=1)
    return _epilogue_plain(y, bias, leaky, x.dtype, want_stats)


def _check_kernel_args(x, kernel, what):
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what}: kernel takes f32 or bf16, got {x.dtype}")
    if x.dim() != 4 or tuple(kernel.shape[:2]) != (3, 3) \
            or kernel.shape[2] != x.shape[-1]:
        raise ValueError(f"{what}: NHWC input and (3, 3, Cin, Cout) kernel "
                         f"expected, got {tuple(x.shape)}, "
                         f"{tuple(kernel.shape)}")


def _conv3x3_kernel(x, kernel, bias, reflect, leaky, want_stats):
    """Launches csrc/conv3x3.cu."""
    _check_kernel_args(x, kernel, "conv3x3")
    b, h, w, c = x.shape
    cout = kernel.shape[-1]
    if reflect and (h < 2 or w < 2):
        raise ValueError("conv3x3: a reflect ring needs H, W >= 2")
    lib = _build.library("conv3x3")
    x = x.contiguous()
    k = kernel.to(device=x.device, dtype=x.dtype).contiguous()
    bias = (torch.zeros(cout, device=x.device) if bias is None
            else bias.to(device=x.device, dtype=torch.float32).contiguous())
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    stats = None
    if want_stats:
        tiles = -(-(h * w) // lib.cocosnet_conv3x3_tile_pixels())
        stats = torch.empty((b, tiles, 2, cout), dtype=torch.float32,
                            device=x.device)
    with torch.cuda.device(x.device):
        err = lib.cocosnet_conv3x3(
            x.data_ptr(), k.data_ptr(), bias.data_ptr(), out.data_ptr(),
            stats.data_ptr() if want_stats else None, b, h, w, c, cout,
            int(reflect), int(leaky is not None), float(leaky or 0.0),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3x3")
    if not want_stats:
        return out
    return (out,) + _moments(stats.sum(dim=1), h * w)


def _no_kernel(what, x):
    if x.device.type != "cpu":
        raise ValueError(f"{what}: no kernel for device {x.device}")


def _refuse_grad(what, *ts):
    """The kernels have no backward: a CUDA input that requires grad
    raises rather than come back without a grad_fn."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward; run "
                           "training convs inside nn.layers.training()")


def conv3x3_fused(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  reflect: bool = False,
                  leaky: Optional[float] = None) -> torch.Tensor:
    """3x3 stride-1 'same' conv, NHWC input, HWIO kernel, with a zero ring
    or (reflect=True) a ReflectionPad2d(1) ring and an optional fused
    LeakyReLU. Output dtype follows x."""
    if x.is_cuda:
        _refuse_grad("conv3x3_fused", x, kernel, bias)
        out = _conv3x3_kernel(x, kernel, bias, reflect, leaky, False)
        conv3x3_fused.launches += 1
        return out
    _no_kernel("conv3x3_fused", x)
    conv3x3_fused.plain_calls += 1
    return conv3x3_plain(x, kernel, bias, reflect=reflect, leaky=leaky)


def conv3x3_fused_stats(x: torch.Tensor, kernel: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, *,
                        reflect: bool = False,
                        leaky: Optional[float] = None):
    """conv3x3_fused plus the instance-norm moments of its f32 output:
    returns (out, mean, var), mean/var f32 (B, 1, 1, Cout)."""
    if x.is_cuda:
        _refuse_grad("conv3x3_fused_stats", x, kernel, bias)
        res = _conv3x3_kernel(x, kernel, bias, reflect, leaky, True)
        conv3x3_fused_stats.launches += 1
        return res
    _no_kernel("conv3x3_fused_stats", x)
    conv3x3_fused_stats.plain_calls += 1
    return conv3x3_plain(x, kernel, bias, reflect=reflect, leaky=leaky,
                         want_stats=True)


def onehot_plain(labels: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor], *, dtype=None,
                 leaky: Optional[float] = None, want_stats: bool = False):
    """Plain version of the one-hot kernel: pad the label map with the -1
    sentinel, expand the one-hot (ids outside [0, C) give zero rows) and
    convolve in f32 with the weights rounded to `dtype`."""
    c = kernel.shape[2]
    dtype = dtype or kernel.dtype
    labq = F.pad(labels.long(), (1, 1, 1, 1), value=-1)
    classes = torch.arange(c, device=labels.device)
    onehot = (labq[..., None] == classes).float().permute(0, 3, 1, 2)
    w = kernel.to(dtype).float().permute(3, 2, 0, 1)
    return _epilogue_plain(F.conv2d(onehot, w), bias, leaky, dtype,
                           want_stats)


def _onehot_kernel(labels, kernel, bias, dtype, leaky, want_stats):
    """Launches csrc/conv3x3_onehot.cu."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"conv3x3_onehot: kernel takes f32 or bf16, got "
                         f"{dtype}")
    if labels.dim() != 3 or tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError("conv3x3_onehot: (B, H, W) labels and a (3, 3, C, "
                         "Cout) kernel expected")
    b, h, w = labels.shape
    c, cout = kernel.shape[2], kernel.shape[3]
    lib = _build.library("conv3x3_onehot")
    lab = labels.to(torch.int32).contiguous()
    k = kernel.to(device=labels.device, dtype=dtype).contiguous()
    bias = (torch.zeros(cout, device=labels.device) if bias is None
            else bias.to(device=labels.device,
                         dtype=torch.float32).contiguous())
    out = torch.empty((b, h, w, cout), dtype=dtype, device=labels.device)
    stats = None
    if want_stats:
        tiles = -(-(h * w) // lib.cocosnet_onehot_tile_pixels())
        stats = torch.empty((b, tiles, 2, cout), dtype=torch.float32,
                            device=labels.device)
    with torch.cuda.device(labels.device):
        err = lib.cocosnet_conv3x3_onehot(
            lab.data_ptr(), k.data_ptr(), bias.data_ptr(), out.data_ptr(),
            stats.data_ptr() if want_stats else None, b, h, w, c, cout,
            int(leaky is not None), float(leaky or 0.0),
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3x3_onehot")
    if not want_stats:
        return out
    return (out,) + _moments(stats.sum(dim=1), h * w)


def conv3x3_onehot(labels: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, *, dtype=None,
                   leaky: Optional[float] = None, want_stats: bool = False):
    """conv3x3_fused(one_hot(labels, C), kernel, bias) with a zero ring and
    the one-hot never materialized. labels: (B, H, W) integer ids; ids
    outside [0, C) contribute zeros. `dtype` is the compute/output dtype
    (default kernel.dtype). With want_stats returns (out, mean, var)."""
    dtype = dtype or kernel.dtype
    if labels.is_cuda:
        _refuse_grad("conv3x3_onehot", kernel, bias)
        res = _onehot_kernel(labels, kernel, bias, dtype, leaky, want_stats)
        conv3x3_onehot.launches += 1
        return res
    _no_kernel("conv3x3_onehot", labels)
    conv3x3_onehot.plain_calls += 1
    return onehot_plain(labels, kernel, bias, dtype=dtype, leaky=leaky,
                        want_stats=want_stats)


for _fn in (conv3x3_fused, conv3x3_fused_stats, conv3x3_onehot):
    _fn.launches = 0
    _fn.plain_calls = 0
