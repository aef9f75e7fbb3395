"""The reflect ring of an NHWC tensor: torch's ReflectionPad2d of width p on
(B, H, W, C), returned NHWC (B, H + 2p, W + 2p, C).

The library convolutions of `nn/layers.conv2d` take their reflect ring from
here, so cuDNN is handed the padded tensor's NCHW view, which is channels-last,
and returns a channels-last output. On a CUDA tensor `reflect_ring` launches
csrc/reflect_ring.cu (a gather forward and, under autograd, a gather
backward without atomics, summing in f32) and counts each launch in
RING_LAUNCHES; on a CPU tensor it is the plain version, F.pad of the NCHW
view, whose values and gradients are the same."""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from cocosnet_tpu_torch.ops import _build

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# launches on the card keyed ("fwd" | "bwd", dtype, p): how often the main
# path builds the ring in NHWC
RING_LAUNCHES: collections.Counter = collections.Counter()


def reflect_ring_plain(x: torch.Tensor, p: int) -> torch.Tensor:
    """The plain version: F.pad(mode="reflect") on the NCHW view, back to
    NHWC (on the CPU the pad keeps the view's channels-last layout)."""
    return F.pad(x.permute(0, 3, 1, 2), (p, p, p, p),
                 mode="reflect").permute(0, 2, 3, 1)


def _vector(nbytes: int, *ptrs: int) -> int:
    """The widest vector, in bytes (16 at most), that divides a pixel's
    bytes and every pointer's alignment (2 at least for f32 and bf16)."""
    return next(v for v in (16, 8, 4, 2)
                if nbytes % v == 0 and all(q % v == 0 for q in ptrs))


def _check(dtype: torch.dtype, shape, p: int) -> None:
    """The kernels' conditions on the input: f32 or bf16, NHWC, p < H, W."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"reflect_ring: kernel takes f32 or bf16, got "
                         f"{dtype}")
    if len(shape) != 4:
        raise ValueError(f"reflect_ring: NHWC input expected, got "
                         f"{tuple(shape)}")
    if not 1 <= p < min(shape[1], shape[2]):
        raise ValueError(f"reflect_ring: a ring of {p} needs 1 <= p < H, W; "
                         f"got {tuple(shape)}")


def _ring_fwd(x: torch.Tensor, p: int) -> torch.Tensor:
    _check(x.dtype, x.shape, p)
    x = x.contiguous()
    b, h, w, c = x.shape
    out = torch.empty((b, h + 2 * p, w + 2 * p, c), dtype=x.dtype,
                      device=x.device)
    esize = x.element_size()
    lib = _build.library("reflect_ring")
    with torch.cuda.device(x.device):
        err = lib.cocosnet_reflect_ring_fwd(
            x.data_ptr(), out.data_ptr(), b, h, w, c, esize, p,
            _vector(c * esize, x.data_ptr(), out.data_ptr()),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "reflect_ring forward")
    RING_LAUNCHES[("fwd", x.dtype, p)] += 1
    return out


def _ring_bwd(g: torch.Tensor, p: int, shape) -> torch.Tensor:
    _check(g.dtype, shape, p)
    g = g.contiguous()
    b, h, w, c = shape
    if tuple(g.shape) != (b, h + 2 * p, w + 2 * p, c):
        raise ValueError(f"reflect_ring backward: gradient {tuple(g.shape)} "
                         f"for an input {tuple(shape)} and a ring of {p}")
    dx = torch.empty(shape, dtype=g.dtype, device=g.device)
    esize = g.element_size()
    lib = _build.library("reflect_ring")
    with torch.cuda.device(g.device):
        err = lib.cocosnet_reflect_ring_bwd(
            g.data_ptr(), dx.data_ptr(), b, h, w, c, esize, p,
            _vector(c * esize, g.data_ptr(), dx.data_ptr()),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "reflect_ring backward")
    RING_LAUNCHES[("bwd", g.dtype, p)] += 1
    return dx


class _Ring(torch.autograd.Function):
    """reflect_ring with the kernel's gather backward."""

    @staticmethod
    def forward(ctx, x, p):
        ctx.p, ctx.shape = p, tuple(x.shape)
        return _ring_fwd(x, p)

    @staticmethod
    def backward(ctx, g):
        return _ring_bwd(g, ctx.p, ctx.shape), None


def reflect_ring(x: torch.Tensor, p: int) -> torch.Tensor:
    """ReflectionPad2d(p) of an NHWC tensor, NHWC (contiguous on the card).
    A CUDA tensor launches csrc/reflect_ring.cu or raises; differentiable."""
    if x.device.type == "cpu":
        return reflect_ring_plain(x, p)
    if not x.is_cuda:
        raise ValueError(f"reflect_ring: no kernel for device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        return _Ring.apply(x, p)
    return _ring_fwd(x, p)
