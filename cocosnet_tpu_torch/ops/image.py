"""Image ops with torch-reference semantics on NHWC tensors.

Counterpart of cocosnet_tpu/ops/image.py, limited to what the flagship
inference and training paths use:
- F.interpolate(mode='nearest')  -> src = floor(dst * in/out)
- nn.Upsample(scale_factor=k)     -> nearest repeat
- F.avg_pool2d / F.max_pool2d     -> stride = kernel, no padding
- the multiscale discriminator's downsample: avg_pool k3 s2 p1,
  count_include_pad=False
- the one-hot label scatter        (pix2pix_model.py:176-187)
- F.unfold patch descriptors       (the correlation A/B tool)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _nearest_indices(out_size: int, in_size: int, device) -> torch.Tensor:
    # torch 'nearest' (not nearest-exact): src = floor(dst * in/out), the
    # product taken in f32 as the reference package does
    idx = torch.floor(torch.arange(out_size, device=device,
                                   dtype=torch.float32) * (in_size / out_size))
    return idx.to(torch.long).clamp(0, in_size - 1)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """F.interpolate(x, size, mode='nearest') on NHWC."""
    n, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    if h % out_h == 0 and w % out_w == 0:
        # integer-factor downscale: floor(i * h/out) == i * (h//out)
        return x[:, :: h // out_h, :: w // out_w]
    hi = _nearest_indices(out_h, h, x.device)
    wi = _nearest_indices(out_w, w, x.device)
    return x[:, hi][:, :, wi]


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """nn.Upsample(scale_factor=scale): integer nearest repeat."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, scale, w, scale, c)
    return x.reshape(n, h * scale, w * scale, c)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """F.avg_pool2d(x, k): stride k, no padding."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), k)
    return y.permute(0, 2, 3, 1).contiguous()


def max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """F.max_pool2d(x, k): stride k, no padding."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k)
    return y.permute(0, 2, 3, 1).contiguous()


def _window_sum_3_s2(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """Sums of the 3-wide, stride-2 windows along `dim` of an input padded
    by one on both sides of that dim."""
    return sum(x.narrow(dim, i, 2 * n_out - 1)[
        (slice(None),) * dim + (slice(None, None, 2),)] for i in range(3))


def avg_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """F.avg_pool2d(x, 3, 2, padding=1, count_include_pad=False), the
    multiscale discriminator's inter-scale downsample, on NHWC: separable
    window sums (accumulated in at least f32) over the zero-padded input,
    divided by the count of in-image taps. Written out, not F.avg_pool2d:
    on CUDA its
    backward for a channels-last input (an NHWC tensor seen as NCHW) is
    wrong (torch 2.11, cu128), which would corrupt the gradient that every
    GAN term sends back through the discriminator to the generator."""
    _, h, w, _ = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1))
    s = _window_sum_3_s2(_window_sum_3_s2(xp, 1, ho), 2, wo)
    ones_h = F.pad(torch.ones(h, device=x.device, dtype=acc), (1, 1))
    ones_w = F.pad(torch.ones(w, device=x.device, dtype=acc), (1, 1))
    count = (_window_sum_3_s2(ones_h, 0, ho)[:, None, None]
             * _window_sum_3_s2(ones_w, 0, wo)[None, :, None])
    return (s / count).to(x.dtype)


def unfold_descriptors(x: torch.Tensor, k: int) -> torch.Tensor:
    """F.unfold(x, kernel_size=k, padding=k//2, stride=1) on NHWC: (N, H*W,
    C*k*k), features in torch's (c, kh, kw) order, the patch descriptors of
    match_kernel > 1."""
    cols = F.unfold(x.permute(0, 3, 1, 2), kernel_size=k, padding=k // 2)
    return cols.transpose(1, 2)


def one_hot_scatter(label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """label (N, H, W) int -> one-hot (N, H, W, num_classes) float32; ids
    outside [0, num_classes) give an all-zero row."""
    classes = torch.arange(num_classes, device=label.device)
    return (label[..., None] == classes).to(torch.float32)
