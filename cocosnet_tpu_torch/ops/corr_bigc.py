"""Flash correlation, softmax and warp at large descriptor widths (C = 2304,
the 3x3-unfold descriptors of match_kernel 3), forward and backward: o =
softmax(q k^T / tau) v with q (B, N, C), k (B, M, C), v (B, M, D).

Counterpart of cocosnet_tpu/ops/pallas_corr_bigc.py `attend_pallas_bigc`,
whose only caller is the correlation A/B tool (tools/bench_corr.py; here
cocosnet_tpu_torch/tools/bench_corr.py). The core is a
torch.autograd.Function. On a CUDA tensor its forward runs csrc/corr_fwd.cu,
the forward kernel of ops/corr.attend_corr: it streams q and k in 32-channel
chunks through shared memory, so C is not bounded by it. Its backward runs
csrc/corr_bigc_bwd.cu, whose owner rows accumulate in device memory (32
rows of 2304 floats do not fit a block's shared memory, which is what
bounds corr_bwd.cu). On a CPU tensor both run the plain versions, which
are ops/corr's `corr_fwd_plain` and `corr_bwd_plain`: the same function.
The Pallas kernel's bf16 hi/lo split of q and k (bf16x4 products) and its
transposed V are choices for the TPU's matrix unit; the CUDA kernels
multiply in f32. Both take any N and M (the Pallas kernel writes only whole
256-row query blocks and reads only whole key blocks, pallas_corr_bigc.py:
106, 203, 223).
"""

from __future__ import annotations

import torch

from cocosnet_tpu_torch.ops import _build
from cocosnet_tpu_torch.ops.corr import (_MAX_SMEM, _check, corr_bwd_plain,
                                         corr_fwd_kernel, corr_fwd_plain)


def corr_bigc_bwd_kernel(q, k, v, tau: float, lse, go, dd):
    """Launches csrc/corr_bigc_bwd.cu (its query pass, then its key pass):
    the outputs of corr_bwd_plain."""
    lib = _build.library("corr_bigc_bwd")
    b, n, c = q.shape
    m, d = v.shape[1], v.shape[2]
    smem = lib.cocosnet_corr_bigc_bwd_smem(d)
    if smem > _MAX_SMEM:
        raise ValueError(f"corr_bigc backward kernel takes a D that fits "
                         f"shared memory; got D={d} ({smem} bytes)")
    _check("corr_bigc backward kernel", (q, (b, n, c)), (k, (b, m, c)),
           (v, (b, m, d)), (lse, (b, n)), (go, (b, n, d)), (dd, (b, n)))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.cocosnet_corr_bigc_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), go.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, n, m, c, d, 1.0 / tau,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "corr_bigc_bwd")
    return dq, dk, dv


def attend_corr_bigc_backward(q, k, v, tau: float, lse, go, dd):
    """The gradients of the core (see corr_bwd_plain): CUDA tensors launch
    csrc/corr_bigc_bwd.cu, CPU tensors run the plain version."""
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
