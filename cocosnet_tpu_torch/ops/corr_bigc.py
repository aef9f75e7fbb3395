"""Flash correlation, softmax and warp at large descriptor widths (C = 2304,
the 3x3-unfold descriptors of match_kernel 3), forward and backward: o =
softmax(q k^T / tau) v with q (B, N, C), k (B, M, C), v (B, M, D).

Counterpart of cocosnet_tpu/ops/pallas_corr_bigc.py `attend_pallas_bigc`,
whose only caller is the correlation A/B tool (tools/bench_corr.py; here
cocosnet_tpu_torch/tools/bench_corr.py). The core is a
torch.autograd.Function. On a CUDA tensor its forward runs csrc/corr_fwd.cu,
the forward kernel of ops/corr.attend_corr (a flash forward in 3xTF32 on
the tensor cores): it streams q and k in 32-channel chunks through shared
memory, so C is not bounded by it. Its backward runs
csrc/corr_bwd.cu, the backward kernel of ops/corr.attend_corr (P and dS
formed once into scratch, then dq, dk and dv on the tensor cores in
3xTF32, over 128-column tiles of C), which takes 32-column dv tiles where
D <= 32 (D = 3 here). On a CPU
tensor both run the plain versions, which are ops/corr's `corr_fwd_plain`
and `corr_bwd_plain`: the same function. The Pallas kernel's bf16x4
products and its transposed V are choices for the TPU's matrix unit; both
CUDA kernels multiply in 3xTF32. Both take any N
and M (the Pallas kernel writes only whole 256-row query blocks and reads
only whole key blocks, pallas_corr_bigc.py: 106, 203, 223).
"""

from __future__ import annotations

import torch

from cocosnet_tpu_torch.ops.corr import (corr_bwd_kernel, corr_bwd_plain,
                                         corr_fwd_kernel, corr_fwd_plain)


def corr_bigc_bwd_kernel(q, k, v, tau: float, lse, go, dd):
    """Launches csrc/corr_bwd.cu at this width: the outputs of
    corr_bwd_plain."""
    return corr_bwd_kernel(q, k, v, tau, lse, go, dd)


def attend_corr_bigc_backward(q, k, v, tau: float, lse, go, dd):
    """The gradients of the core (see corr_bwd_plain): CUDA tensors launch
    csrc/corr_bwd.cu, CPU tensors run the plain version."""
    if q.is_cuda:
        res = corr_bigc_bwd_kernel(q, k, v, tau, lse, go, dd)
        attend_corr_bigc_backward.launches += 1
        return res
    if q.device.type != "cpu":
        raise ValueError(f"attend_corr_bigc: no kernel for device {q.device}")
    attend_corr_bigc_backward.plain_calls += 1
    return corr_bwd_plain(q, k, v, tau, lse, go, dd)


class _BigcCore(torch.autograd.Function):
    """o = softmax(q k^T / tau) v, saving the row logsumexp for the
    backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, tau):
        if q.is_cuda:
            o, lse = corr_fwd_kernel(q, k, v, tau)
            attend_corr_bigc.launches += 1
        else:
            o, lse = corr_fwd_plain(q, k, v, tau)
            attend_corr_bigc.plain_calls += 1
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tau = tau
        return o

    @staticmethod
    def backward(ctx, go):
        q, k, v, o, lse = ctx.saved_tensors
        go = go.float().contiguous()
        dd = (go * o).sum(-1)
        dq, dk, dv = attend_corr_bigc_backward(q, k, v, ctx.tau, lse, go, dd)
        return dq, dk, dv, None


def attend_corr_bigc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     tau: float) -> torch.Tensor:
    """softmax(q k^T / tau, dim=-1) v for q (B, N, C), k (B, M, C), v (B, M,
    D) at any descriptor width C, in f32 and differentiable in all three.
    CUDA tensors run the kernels, CPU tensors their plain versions."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"attend_corr_bigc: no kernel for device {q.device}")
    return _BigcCore.apply(q.float().contiguous(), k.float().contiguous(),
                           v.float().contiguous(), tau)


for _fn in (attend_corr_bigc, attend_corr_bigc_backward):
    _fn.launches = 0
    _fn.plain_calls = 0
