"""The benchmark's yardstick of work: the card's published peaks, the
operation and byte counts of the hand-written kernels' calls, the kernel
families by name, and the model FLOPs of a cell counted on the plain
reference.

The formulas and the family table are copies of the port's
cocosnet_tpu_torch/utils/profiling.py (conv3x3_flops, shift9_fwd_flops,
shift9_bwd_flops, KERNEL_FAMILIES), kept here so that a change to the
program cannot change what its shares are measured against.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Callable, Dict, Iterator, Tuple
from unittest import mock

import torch

# published peaks of one H100 SXM, dense (NVIDIA's data sheet)
BF16_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12


def conv3x3_flops(b, h, w, ci, co) -> float:
    """A 3x3 'same' conv: 2 B H W 9 Cin Cout."""
    return 2.0 * b * h * w * 9 * ci * co


def shift9_fwd_flops(b, nq, nk, c, d) -> float:
    """The 3x3-unfold correlation forward on C-channel features: S3 = F3
    G3^T over 3C and P V over D, 2 B Nq Nk (3C + D)."""
    return 2.0 * b * nq * nk * (3 * c + d)


def shift9_bwd_flops(b, nq, nk, c, d) -> float:
    """Its backward: S3 and dP = gO V^T once each, then dF3 = dS3 G3,
    dG3 = dS3^T F3 and dV = P^T gO, 2 B Nq Nk (3 x 3C + 2 D)."""
    return 2.0 * b * nq * nk * (9 * c + 2 * d)


def bound_s(ops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds, what bounds it): the operations at the bf16 dense
    peak or the bytes at the HBM rate, whichever is longer."""
    t_ops, t_bytes = ops / BF16_FLOP_S, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# Kernel families by substrings of the device kernel's name, first match
# wins; anything else is "elementwise / other".
KERNEL_FAMILIES = (
    ("conv3x3.cu", ("conv3x3_bf16_kernel", "conv3x3_f32_kernel")),
    ("conv operand copies", ("pad_channels", "k_major_weights")),
    ("conv3x3_onehot.cu", ("onehot::",)),
    ("shift9_fwd.cu", ("shift9_fwd::",)),
    ("shift9_bwd.cu", ("shift9_bwd_scores_kernel", "shift9_bwd_reduce_kernel",
                       "shift9_bwd::src")),
    ("corr_fwd.cu", ("corr_fwd_kernel",)),
    ("corr_bwd.cu", ("corr_bwd_scores_kernel", "corr_bwd::src")),
    ("conv3x3_dw.cu", ("conv3x3_dw_bf16_kernel", "conv3x3_dw_f32_kernel",
                       "reduce_splits")),
    ("library conv (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                              "implicit")),
    ("library matmul", ("gemm", "cutlass", "cublas")),
    ("optimizer (Adam, EMA)", ("multi_tensor", "adam")),
    ("softmax / reductions", ("softmax", "reduce", "norm")),
)
ELEMENTWISE = "elementwise / other"


def family(kernel_name: str) -> str:
    low = kernel_name.lower()
    return next((f for f, subs in KERNEL_FAMILIES
                 if any(s in low for s in subs)), ELEMENTWISE)


# The hand-written kernels whose calls are counted: (family, module,
# function of one launch, (family's once-a-call kernel names), the
# operations of one call from its arguments). The functions are the port's
# launch functions; each call's bytes are its tensor inputs and outputs.
def _conv_ops(x, kernel, *_):
    b, h, w, ci = x.shape
    return conv3x3_flops(b, h, w, ci, kernel.shape[-1])


def _shift9_fwd_ops(f3, g3, v, *_):
    return shift9_fwd_flops(f3.shape[0], f3.shape[1], g3.shape[1],
                            f3.shape[2] // 3, v.shape[-1])


def _shift9_bwd_ops(f3, g3, v, *_):
    return shift9_bwd_flops(f3.shape[0], f3.shape[1], g3.shape[1],
                            f3.shape[2] // 3, v.shape[-1])


COUNTED = (
    ("conv3x3.cu", "cocosnet_tpu_torch.ops.conv3x3", "_conv3x3_kernel",
     ("conv3x3_bf16_kernel", "conv3x3_f32_kernel"), _conv_ops),
    ("shift9_fwd.cu", "cocosnet_tpu_torch.ops.shift9", "shift9_core_kernel",
     ("shift9_fwd::shift9_fwd_kernel",), _shift9_fwd_ops),
    ("shift9_bwd.cu", "cocosnet_tpu_torch.ops.shift9", "shift9_bwd_kernel",
     ("shift9_bwd_scores_kernel",), _shift9_bwd_ops),
)


def _tensors(obj) -> Iterator[torch.Tensor]:
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)


def _nbytes(ts) -> int:
    seen, total = set(), 0
    for t in ts:
        key = (t.data_ptr(), t.numel(), t.dtype)
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


@contextlib.contextmanager
def counted_calls() -> Iterator[Dict[str, dict]]:
    """Within the block, each call of a counted kernel's launch function
    adds to {family: {"calls", "ops", "bytes", "bound_s"}} (bound_s the sum
    of each call's own bound)."""
    tally = {fam: dict(calls=0, ops=0.0, bytes=0.0, bound_s=0.0)
             for fam, *_ in COUNTED}
    with contextlib.ExitStack() as stack:
        for fam, module, name, _, ops in COUNTED:
            mod = importlib.import_module(module)
            real = getattr(mod, name)

            def spy(*args, _real=real, _fam=fam, _ops=ops, **kw):
                out = _real(*args, **kw)
                n_ops = _ops(*args)
                n_bytes = (_nbytes(_tensors(args))
                           + _nbytes(_tensors(out)))
                rec = tally[_fam]
                rec["calls"] += 1
                rec["ops"] += n_ops
                rec["bytes"] += n_bytes
                rec["bound_s"] += bound_s(n_ops, n_bytes)[0]
                return out

            stack.enter_context(mock.patch.object(mod, name, spy))
        yield tally


def call_markers(fam: str) -> Tuple[str, ...]:
    return next(m for f, _, _, m, _ in COUNTED if f == fam)


def model_flops(fn: Callable[[], object]) -> float:
    """FLOPs of one call of fn by torch.utils.flop_counter's registry of
    operator formulas (convolutions and their backward, matrix products),
    applied as FlopCounterMode applies it, without its per-module
    tracking."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Counter(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.total += formula(*args, **kwargs, out_val=out)
            return out

    counter = Counter()
    with counter:
        fn()
    return float(counter.total)
