"""Fused correlation, softmax and warp of dense descriptors (match_kernel=1),
forward and backward: o = softmax(q k^T / tau) v with q (B, N, C), k (B, M,
C), v (B, M, D).

Counterpart of cocosnet_tpu/ops/pallas_corr.py `attend_pallas`. The core
is a torch.autograd.Function: its forward runs the hand-written CUDA kernel
csrc/corr_fwd.cu (a flash forward, 3xTF32 on the tensor cores) on a CUDA
tensor, or its plain PyTorch version
(`corr_fwd_plain`) on a CPU tensor, and saves the row logsumexp; its
backward forms dd = rowsum(gO * O) and runs csrc/corr_bwd.cu (P and dS
formed once into scratch, then dq, dk and dv, all on the tensor cores in
3xTF32; the same kernels serve ops/corr_bigc at C = 2304), or
`corr_bwd_plain` on the CPU. Both kernels take any N and M (the Pallas
kernel writes only whole 128-row query blocks and reads only whole key
chunks). V rides as (B, M, D): the Pallas kernel's transposed layout is a
choice for the TPU's lanes.
"""

from __future__ import annotations

import torch

from cocosnet_tpu_torch.ops import _build


def _logits(q, k, tau):
    return torch.matmul(q, k.transpose(1, 2)) * (1.0 / tau)


def corr_fwd_plain(q, k, v, tau: float):
    """Plain PyTorch version of the forward kernel (pallas_corr.py
    `_fwd_kernel` on whole matrices): (o (B, N, D), lse (B, N))."""
    s = _logits(q, k, tau)
    lse = torch.logsumexp(s, dim=-1)
    return torch.matmul(torch.exp(s - lse[..., None]), v), lse


def corr_bwd_plain(q, k, v, tau: float, lse, go, dd):
    """Plain PyTorch version of the backward kernel (pallas_corr.py
    `_dq_kernel` and `_dkv_kernel` on whole matrices): from the saved lse,
    the output gradient go (B, N, D) and dd = rowsum(go * o) (B, N),
    returns dq (B, N, C), dk (B, M, C) and dv (B, M, D)."""
    p = torch.exp(_logits(q, k, tau) - lse[..., None])
    ds = p * (torch.matmul(go, v.transpose(1, 2)) - dd[..., None])
    dq = torch.matmul(ds, k) * (1.0 / tau)
    dk = torch.matmul(ds.transpose(1, 2), q) * (1.0 / tau)
    return dq, dk, torch.matmul(p.transpose(1, 2), go)


def _check(what, *pairs):
    """Each (tensor, shape): contiguous f32 of that shape, all on one
    device."""
    dev = pairs[0][0].device
    for t, shape in pairs:
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{what} takes contiguous f32 tensors on one "
                             f"device, q (B, N, C), k (B, M, C), v (B, M, "
                             f"D); got {tuple(t.shape)} {t.dtype}")


def corr_fwd_kernel(q, k, v, tau: float):
    """Launches csrc/corr_fwd.cu (a flash forward on the tensor cores in
    3xTF32) on rows padded to 16 bytes: (o (B, N, D), lse (B, N))."""
    lib = _build.library("corr_fwd")
    b, n, c = q.shape
    m, d = v.shape[1], v.shape[2]
    if d > lib.cocosnet_corr_max_d():
        raise ValueError(f"corr kernel takes D <= {lib.cocosnet_corr_max_d()};"
                         f" got D={d}")
    _check("corr kernel", (q, (b, n, c)), (k, (b, m, c)), (v, (b, m, d)))
    if b > 65535:
        raise ValueError(f"corr kernel takes B <= 65535 (its grid's second "
                         f"dimension); got B={b}")
    ops = [_rows16(t) for t in (q, k, v)]
    o = torch.empty((b, n, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.cocosnet_corr_fwd(
            *(t.data_ptr() for t in ops), o.data_ptr(),
            lse.data_ptr(), b, n, m, c, d, 1.0 / tau,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "corr_fwd")
    return o, lse


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """t with its last dimension zero-padded to a multiple of 4 and its
    start 16-byte aligned (a copy only where needed): rows the kernels can
    load with 16-byte copies."""
    pad = -t.shape[-1] % 4
    if pad:
        return torch.nn.functional.pad(t, (0, pad))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def corr_bwd_kernel(q, k, v, tau: float, lse, go, dd):
    """Launches csrc/corr_bwd.cu (scores, then dq, dk and dv on the tensor
    cores) with its P and dS scratch: the outputs of corr_bwd_plain."""
    lib = _build.library("corr_bwd")
    b, n, c = q.shape
    m, d = v.shape[1], v.shape[2]
    _check("corr_bwd kernel", (q, (b, n, c)), (k, (b, m, c)),
           (v, (b, m, d)), (lse, (b, n)), (go, (b, n, d)), (dd, (b, n)))
    if b > 65535:
        raise ValueError(f"corr_bwd kernel takes B <= 65535 (its grid's "
                         f"third dimension); got B={b}")
    tile = lib.cocosnet_corr_bwd_tile()
    npad, mpad = -(-n // tile) * tile, -(-m // tile) * tile
    ops = [_rows16(t) for t in (q, k, v, go)]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    p = torch.empty((b, npad, mpad), dtype=torch.float32, device=q.device)
    ds = torch.empty_like(p)
    with torch.cuda.device(q.device):
        err = lib.cocosnet_corr_bwd(
            *(t.data_ptr() for t in ops), lse.data_ptr(), dd.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), p.data_ptr(),
            ds.data_ptr(), b, n, m, c, d, 1.0 / tau,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "corr_bwd")
    return dq, dk, dv


def attend_corr_backward(q, k, v, tau: float, lse, go, dd):
    """The gradients of the core (see corr_bwd_plain): CUDA tensors launch
    csrc/corr_bwd.cu, CPU tensors run the plain version."""
    if q.is_cuda:
        res = corr_bwd_kernel(q, k, v, tau, lse, go, dd)
        attend_corr_backward.launches += 1
        return res
    if q.device.type != "cpu":
        raise ValueError(f"attend_corr: no kernel for device {q.device}")
    attend_corr_backward.plain_calls += 1
    return corr_bwd_plain(q, k, v, tau, lse, go, dd)


class _CorrCore(torch.autograd.Function):
    """o = softmax(q k^T / tau) v, with the backward on the backward
    kernel."""

    @staticmethod
    def forward(ctx, q, k, v, tau):
        if q.is_cuda:
            o, lse = corr_fwd_kernel(q, k, v, tau)
            attend_corr.launches += 1
        else:
            o, lse = corr_fwd_plain(q, k, v, tau)
            attend_corr.plain_calls += 1
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tau = tau
        return o

    @staticmethod
    def backward(ctx, go):
        q, k, v, o, lse = ctx.saved_tensors
        go = go.float().contiguous()
        dd = (go * o).sum(-1)
        dq, dk, dv = attend_corr_backward(q, k, v, ctx.tau, lse, go, dd)
        return dq, dk, dv, None


def attend_corr(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                tau: float) -> torch.Tensor:
    """softmax(q k^T / tau, dim=-1) v for q (B, N, C), k (B, M, C), v (B, M,
    D), in f32 and differentiable in all three. CUDA tensors run the
    kernels, CPU tensors their plain versions."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"attend_corr: no kernel for device {q.device}")
    return _CorrCore.apply(q.float().contiguous(), k.float().contiguous(),
                           v.float().contiguous(), tau)


for _fn in (attend_corr, attend_corr_backward):
    _fn.launches = 0
    _fn.plain_calls = 0
