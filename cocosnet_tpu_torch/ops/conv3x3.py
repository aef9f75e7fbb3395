"""Fused 3x3 stride-1 convolutions: dense (with a statistics variant and a
backward), one-hot input, and the weight gradient of the training route.

Counterpart of cocosnet_tpu/ops/pallas_conv.py `conv3x3_fused` (with its
custom VJP), `conv3x3_fused_stats`, `conv3x3_onehot`, `conv3x3_dw` and
`conv3x3_xla_pdw`, with the JAX package's layout: NHWC activations, HWIO
kernels, f32 bias, output in the activation dtype, f32 accumulation. On a
CUDA tensor each wrapper launches its hand-written kernel (csrc/conv3x3.cu,
csrc/conv3x3_onehot.cu, csrc/conv3x3_dw.cu) and counts the launch; on a CPU
tensor it runs the plain PyTorch version of the same function.

`conv3x3_fused` on inputs that require grad is a torch.autograd.Function
whose backward computes dx through csrc/conv3x3.cu again (counted as
`conv3x3_fused_backward`). The statistics and one-hot entries have no
backward, as in the JAX package, so a CUDA input that requires grad raises.
`conv3x3_xla_pdw` is the training route of COCOSNET_PALLAS_DW: the library
conv forward and input gradient, the weight and bias gradients on
csrc/conv3x3_dw.cu.

The statistics are the kernel's: per-(sample, channel) mean and biased
variance of the f32 output before rounding, the variance single-pass,
E[x^2] - E[x]^2 clamped at 0 (pallas_conv.py:692-701).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from cocosnet_tpu_torch.ops import _build

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# "1" routes the training convs of the winners table below through
# conv3x3_xla_pdw, "all" every convolution of the size conditions; "0" (the
# default) none
DW_ENV = "COCOSNET_PALLAS_DW"
# The JAX package's winners table (pallas_conv.py:497-504), keyed (H, W,
# Cin, Cout, reflect): the shapes where its dW kernel beat XLA's on its TPU.
# Copied as it stands; the JAX package's routing, not an H100 measurement.
DW_WINNERS = frozenset({
    (64, 64, 128, 512, True),
    (64, 64, 512, 512, True),
    (64, 64, 128, 256, True),
    (64, 64, 256, 256, True),
    (64, 64, 154, 128, True),
    (128, 128, 154, 128, True),
})


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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _pad_scratch(x: torch.Tensor, *shapes):
    """Per operand shape (..., C): for a bf16 launch whose C is not a
    multiple of 8, scratch of (..., C rounded up to 8) bf16 for the
    channel-padded copy the kernel reads (csrc/conv3x3_common.cuh
    `pad_channels`); else None."""
    if x.dtype != torch.bfloat16:
        return (None,) * len(shapes)
    return tuple(None if s[-1] % 8 == 0 else torch.empty(
        (*s[:-1], -(-s[-1] // 8) * 8), dtype=torch.bfloat16, device=x.device)
        for s in shapes)


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
    (x_pad,) = _pad_scratch(x, (b, h, w, c))
    # bf16: scratch for the K-major weights the kernel reads
    k_t = None if x.dtype != torch.bfloat16 else torch.empty(
        (cout, 3, 3, -(-c // 8) * 8), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.cocosnet_conv3x3(
            x.data_ptr(), k.data_ptr(), bias.data_ptr(), out.data_ptr(),
            stats.data_ptr() if want_stats else None, _ptr(x_pad),
            _ptr(k_t), b, h, w, c, cout, int(reflect),
            int(leaky is not None), float(leaky or 0.0),
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


def _fused_forward(x, kernel, bias, reflect, leaky):
    if x.is_cuda:
        out = _conv3x3_kernel(x, kernel, bias, reflect, leaky, False)
        conv3x3_fused.launches += 1
        return out
    _no_kernel("conv3x3_fused", x)
    conv3x3_fused.plain_calls += 1
    return conv3x3_plain(x, kernel, bias, reflect=reflect, leaky=leaky)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _oihw(kernel: torch.Tensor) -> torch.Tensor:
    return kernel.permute(3, 2, 0, 1)


def _pad_nchw(xc: torch.Tensor, reflect: bool) -> torch.Tensor:
    return F.pad(xc, (1, 1, 1, 1), mode="reflect" if reflect else "constant")


def _reflect_ring_adjoint(dx, gk, kernel):
    """Adds to dx (the interior of d(padded x), the zero-ring conv of g with
    the rotated kernel) what the ReflectionPad2d ring's cells send back onto
    the rows and columns they copy (pallas_conv.py:288-314): each ring cell
    depends on one edge row or column of g, so four 1-D correlations in f32,
    rounded to dx's dtype, then the reflect scatter (-1 -> 1, n -> n-2;
    corners ride the top and bottom rows)."""
    bsz, hh, ww, _ = gk.shape
    kf = kernel.float()

    def line1d(line, wline, n):
        """sum_v line(t - v) wline[v] along one boundary: (B, n + 2, Cin)."""
        lf = line.float()
        out = lf.new_zeros(bsz, n + 2, kf.shape[2])
        for v in range(3):
            out[:, v:v + n] += torch.einsum("bto,io->bti", lf, wline[v])
        return out.to(dx.dtype)

    top = line1d(gk[:, 0], kf[0], ww)
    bot = line1d(gk[:, -1], kf[2], ww)
    left = line1d(gk[:, :, 0], kf[:, 0], hh)
    right = line1d(gk[:, :, -1], kf[:, 2], hh)
    dx[:, 1, :] += top[:, 1:ww + 1]
    dx[:, 1, 1] += top[:, 0]
    dx[:, 1, ww - 2] += top[:, ww + 1]
    dx[:, hh - 2, :] += bot[:, 1:ww + 1]
    dx[:, hh - 2, 1] += bot[:, 0]
    dx[:, hh - 2, ww - 2] += bot[:, ww + 1]
    dx[:, :, 1] += left[:, 1:hh + 1]
    dx[:, :, ww - 2] += right[:, 1:hh + 1]
    return dx


def _fused_backward(x, kernel, out, g, reflect, leaky, need, conv):
    """pallas_conv._bwd: the LeakyReLU inverted from the output's sign, db
    the f32 sum of g, dx the zero-ring conv `conv` of g (rounded to x's
    dtype) with the 180-degree-rotated, IO-swapped kernel plus, for a
    reflect ring, the ring's scatter, and dW the library's weight gradient
    on the padded x, in x's dtype as XLA's conv there, returned in f32.
    `need` = (dx, dW, db): what is not needed is not computed (None)."""
    g = g.float()
    if leaky is not None:
        g = torch.where(out >= 0, g, leaky * g)
    db = g.sum(dim=(0, 1, 2)) if need[2] else None
    gk = g.to(x.dtype)
    dx = dw = None
    if need[0]:
        krot = kernel.flip(0, 1).transpose(2, 3).to(x.dtype).contiguous()
        dx = conv(gk, krot)
        if reflect:
            dx = _reflect_ring_adjoint(dx, gk, kernel)
    if need[1]:
        xp = _pad_nchw(_nchw(x), reflect)
        dw = torch.nn.grad.conv2d_weight(
            xp, (kernel.shape[3], kernel.shape[2], 3, 3), _nchw(gk))
        dw = dw.permute(2, 3, 1, 0).float()
    return dx, dw, db


def conv3x3_fused_backward_plain(x, kernel, out, g, *, reflect=False,
                                 leaky=None, need=(True, True, True)):
    """Plain version of conv3x3_fused_backward: its dx conv is
    conv3x3_plain."""
    return _fused_backward(x, kernel, out, g, reflect, leaky, need,
                           lambda gk, krot: conv3x3_plain(gk, krot, None))


def conv3x3_fused_backward(x, kernel, out, g, *, reflect=False, leaky=None,
                           need=(True, True, True)):
    """(dx, dW, db) of conv3x3_fused(x, kernel, bias, reflect, leaky) for
    the output `out` (read only with a LeakyReLU) and its gradient g. On a
    CUDA tensor the dx conv launches csrc/conv3x3.cu, counted here; on a CPU
    tensor it is the plain version."""
    if x.is_cuda:
        res = _fused_backward(
            x, kernel, out, g, reflect, leaky, need,
            lambda gk, krot: _conv3x3_kernel(gk, krot, None, False, None,
                                             False))
        conv3x3_fused_backward.launches += int(bool(need[0]))
        return res
    _no_kernel("conv3x3_fused", x)
    conv3x3_fused_backward.plain_calls += int(bool(need[0]))
    return conv3x3_fused_backward_plain(x, kernel, out, g, reflect=reflect,
                                        leaky=leaky, need=need)


class _FusedConv(torch.autograd.Function):
    """conv3x3_fused with the backward of pallas_conv._bwd: x, the kernel
    and, only with a LeakyReLU, the output are saved."""

    @staticmethod
    def forward(ctx, x, kernel, bias, reflect, leaky):
        out = _fused_forward(x, kernel, bias, reflect, leaky)
        ctx.save_for_backward(x, kernel, out if leaky is not None else None)
        ctx.reflect, ctx.leaky = reflect, leaky
        return out

    @staticmethod
    def backward(ctx, g):
        x, kernel, out = ctx.saved_tensors
        dx, dw, db = conv3x3_fused_backward(
            x, kernel, out, g, reflect=ctx.reflect, leaky=ctx.leaky,
            need=ctx.needs_input_grad[:3])
        return dx, dw, db, None, None


def conv3x3_fused(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  reflect: bool = False,
                  leaky: Optional[float] = None) -> torch.Tensor:
    """3x3 stride-1 'same' conv, NHWC input, HWIO kernel, with a zero ring
    or (reflect=True) a ReflectionPad2d(1) ring and an optional fused
    LeakyReLU. Output dtype follows x. Differentiable: on inputs that
    require grad it runs as _FusedConv."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, kernel, bias)):
        return _FusedConv.apply(x, kernel, bias, reflect, leaky)
    return _fused_forward(x, kernel, bias, reflect, leaky)


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
    """Launches csrc/conv3x3_onehot.cu: the gather (the weight table in
    shared memory, about one block an SM), then with want_stats the
    moments' launch, which sums the per-block partials in a fixed order."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"conv3x3_onehot: kernel takes f32 or bf16, got "
                         f"{dtype}")
    if labels.dim() != 3 or tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError("conv3x3_onehot: (B, H, W) labels and a (3, 3, C, "
                         "Cout) kernel expected")
    b, h, w = labels.shape
    c, cout = kernel.shape[2], kernel.shape[3]
    lib = _build.library("conv3x3_onehot")
    is_bf16 = int(dtype == torch.bfloat16)
    sms = torch.cuda.get_device_properties(
        labels.device).multi_processor_count
    blocks = lib.cocosnet_onehot_blocks(b, h, w, c, cout, is_bf16, sms)
    if blocks == 0:
        raise ValueError(f"conv3x3_onehot: the weight table of {c} classes "
                         f"does not fit the kernel's shared memory")
    lab = labels.to(torch.int32).contiguous()
    # the table's rows as 16-byte vectors: Cout padded to a multiple of 8
    k = kernel.to(device=labels.device, dtype=dtype)
    k = F.pad(k, (0, -cout % 8)) if cout % 8 else k.contiguous()
    if k.data_ptr() % 16:
        k = k.clone()
    bias = (torch.zeros(cout, device=labels.device) if bias is None
            else bias.to(device=labels.device,
                         dtype=torch.float32).contiguous())
    out = torch.empty((b, h, w, cout), dtype=dtype, device=labels.device)
    part = moments = None
    if want_stats:
        part = torch.empty((b, blocks, 2, cout), dtype=torch.float32,
                           device=labels.device)
        moments = torch.empty((2, b, cout), dtype=torch.float32,
                              device=labels.device)
    with torch.cuda.device(labels.device):
        err = lib.cocosnet_conv3x3_onehot(
            lab.data_ptr(), k.data_ptr(), bias.data_ptr(), out.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (part, moments)),
            b, h, w, c, cout, int(leaky is not None), float(leaky or 0.0),
            is_bf16, sms, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3x3_onehot")
    if not want_stats:
        return out
    return out, moments[0, :, None, None, :], moments[1, :, None, None, :]


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


def conv3x3_dw_plain(x: torch.Tensor, g: torch.Tensor, *,
                     reflect: bool = False):
    """Plain version of the dW kernel: (dw (3, 3, Cin, Cout) f32, db (Cout,)
    f32), the f32 correlation of the padded x with g, both as rounded to x's
    dtype, tap by tap; db sums that rounded g (pallas_conv.py:569 rounds g
    before :429 sums it)."""
    b, h, w, cin = x.shape
    gf = g.to(x.dtype).float().reshape(-1, g.shape[-1])
    xp = _pad_nchw(_nchw(x.float()), reflect).permute(0, 2, 3, 1)
    dw = torch.stack([torch.stack([
        xp[:, dy:dy + h, dx:dx + w].reshape(-1, cin).t() @ gf
        for dx in range(3)]) for dy in range(3)])
    return dw, gf.sum(dim=0)


def _conv3x3_dw_kernel(x, g, reflect):
    """Launches csrc/conv3x3_dw.cu: per (tap, input-channel tile,
    output-channel tile, split of the batch's pixels) a partial dW, then,
    with more than one split, the ordered sum of the partials."""
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"conv3x3_dw: kernel takes f32 or bf16, got "
                         f"{x.dtype}")
    if x.dim() != 4 or g.dim() != 4 or g.shape[:3] != x.shape[:3]:
        raise ValueError(f"conv3x3_dw: x (B, H, W, Cin) and g (B, H, W, "
                         f"Cout) expected, got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}")
    b, h, w, cin = x.shape
    cout = g.shape[-1]
    if reflect and (h < 2 or w < 2):
        raise ValueError("conv3x3_dw: a reflect ring needs H, W >= 2")
    lib = _build.library("conv3x3_dw")
    x = x.contiguous()
    g = g.to(device=x.device, dtype=x.dtype).contiguous()
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    db = torch.empty(cout, dtype=torch.float32, device=x.device)
    is_bf16 = int(x.dtype == torch.bfloat16)
    splits = lib.cocosnet_conv3x3_dw_splits(b, h, w, cin, cout, is_bf16)
    part = None
    if splits > 1:
        part = torch.empty((splits, 9 * cin * cout + cout),
                           dtype=torch.float32, device=x.device)
    x_pad, g_pad = _pad_scratch(x, (b, h, w, cin), (b, h, w, cout))
    with torch.cuda.device(x.device):
        err = lib.cocosnet_conv3x3_dw(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(), db.data_ptr(),
            _ptr(part), _ptr(x_pad), _ptr(g_pad), b, h, w, cin, cout,
            int(reflect), is_bf16, splits,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3x3_dw")
    return dw, db


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor, *, reflect: bool = False):
    """Weight and bias gradient of a 3x3 stride-1 'same' conv with a zero or
    (reflect=True) ReflectionPad2d(1) ring, for its input x (B, H, W, Cin)
    and output gradient g (B, H, W, Cout), g rounded to x's dtype: (dw (3,
    3, Cin, Cout) f32, db (Cout,) f32)."""
    if x.is_cuda:
        res = _conv3x3_dw_kernel(x, g, reflect)
        conv3x3_dw.launches += 1
        return res
    _no_kernel("conv3x3_dw", x)
    conv3x3_dw.plain_calls += 1
    return conv3x3_dw_plain(x, g, reflect=reflect)


def conv3x3_dw_supported(x_shape, g_shape, *, reflect: bool = False) -> bool:
    """pallas_conv.conv3x3_dw_supported less its TPU-only conditions (the
    TPU check and the VMEM tile search, which have no H100 meaning): DW_ENV,
    read at each call ("0" or "false", the default: never; "all": every
    shape of the size conditions; anything else: the DW_WINNERS shapes),
    then the size conditions of the forward kernel."""
    mode = os.environ.get(DW_ENV, "0")
    if mode in ("0", "false"):
        return False
    _, h, w, c = x_shape
    cout = g_shape[-1]
    if mode != "all" and (h, w, c, cout, reflect) not in DW_WINNERS:
        return False
    return (w % 16 == 0 and w >= 32 and h >= 8 and h * w >= 2048
            and c >= 64 and cout >= 64)


def _library_conv(x, kernel, reflect):
    """The training route's library conv: F.pad (reflect) and F.conv2d on
    the NCHW view of x; returns NCHW."""
    xc = _nchw(x)
    if reflect:
        y = F.conv2d(_pad_nchw(xc, True), _oihw(kernel))
    else:
        y = F.conv2d(xc, _oihw(kernel), padding=1)
    return y


class _XlaPdw(torch.autograd.Function):
    """pallas_conv.conv3x3_xla_pdw: the forward and dx are the library ops
    of the plain training route; dW and db are conv3x3_dw. The kernel
    arrives as the caller holds it (f32 under the bf16 policy) and is
    rounded to x's dtype here, so the f32 dW reaches an f32 weight without
    a bf16 rounding, as JAX's custom VJP hands back an f32 dw (:570)."""

    @staticmethod
    def forward(ctx, x, kernel, bias, reflect):
        k = kernel.to(x.dtype)
        ctx.save_for_backward(x, k)
        ctx.reflect = reflect
        y = _library_conv(x, k, reflect)
        if bias is not None:
            y = y + bias.to(x.dtype)[None, :, None, None]
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if need_x:
            gc = _nchw(g.to(x.dtype))
            xc = _nchw(x)
            if ctx.reflect:
                b, c, h, w = xc.shape
                dxp = torch.nn.grad.conv2d_input((b, c, h + 2, w + 2),
                                                 _oihw(k), gc)
                dx = torch.ops.aten.reflection_pad2d_backward(
                    dxp, xc, [1, 1, 1, 1])
            else:
                dx = torch.nn.grad.conv2d_input(xc.shape, _oihw(k), gc,
                                                padding=1)
            dx = dx.permute(0, 2, 3, 1)
        # Only where a gradient is asked for: the frozen VGG's convs take
        # this route under COCOSNET_PALLAS_DW=all, and no dW launch is
        # spent on their weights.
        if need_w or need_b:
            dw, db = conv3x3_dw(x, g, reflect=ctx.reflect)
        return dx, dw if need_w else None, db if need_b else None, None


def conv3x3_xla_pdw(x: torch.Tensor, kernel: torch.Tensor,
                    bias: Optional[torch.Tensor], reflect: bool):
    """3x3 stride-1 'same' conv (zero or reflect ring) + bias, NHWC in and
    out, whose forward and input gradient are the library conv and whose
    weight and bias gradients run conv3x3_dw. Output dtype follows x."""
    return _XlaPdw.apply(x, kernel, bias, reflect)


for _fn in (conv3x3_fused, conv3x3_fused_stats, conv3x3_onehot,
            conv3x3_fused_backward, conv3x3_dw):
    _fn.launches = 0
    _fn.plain_calls = 0
