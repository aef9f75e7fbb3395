"""Fused 3x3-unfold correlation + softmax + warp (match_kernel=3), forward.

Counterpart of cocosnet_tpu/ops/pallas_shift9.py `attend_shift9`. The
wrapper prepares, in PyTorch, what the kernel consumes (pallas_shift9.py:
407-472): the dy taps folded into channels (F3/G3, 3C wide) and the rank-1
centering/normalization terms qv (B, N, 4: qs, qmul, qadd, cadd) and
kv (B, 4, N: ks, kmul, kadd, 0), 1/tau folded into qs. The core then runs
as the hand-written CUDA kernel csrc/shift9_fwd.cu on a CUDA tensor, or as
its plain PyTorch version (`shift9_core_plain`) on a CPU tensor.
"""

from __future__ import annotations

import torch

from cocosnet_tpu_torch.ops import _build
from cocosnet_tpu_torch.ops.corr_shift import (_cross_map, _pad_hw,
                                               _safe_norm, _shift_means,
                                               _unfold_stats)


def _row_stack3(x: torch.Tensor) -> torch.Tensor:
    """F3(h, w) = [f(h-1, w) | f(h, w) | f(h+1, w)], zero-padded rows."""
    b, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    return torch.cat([xp[:, dy:dy + h] for dy in range(3)], dim=-1)


def shift9_inputs(f: torch.Tensor, g: torch.Tensor, tau: float,
                  pono_c: bool = True):
    """(f3, g3, qv, kv) of the kernel from raw (B, H, W, C) features."""
    b, h, w, c = f.shape
    n = h * w
    cd = c * 9
    f = f.float()
    g = g.float()
    fs1, fs2 = _unfold_stats(f, 3)
    gs1, gs2 = _unfold_stats(g, 3)
    if pono_c:
        q_mu = (fs1 / cd).reshape(b, n)
        k_mu = (gs1 / cd).reshape(b, n)
        q_norm = _safe_norm((fs2 - fs1 * fs1 / cd).reshape(b, n))
        k_norm = _safe_norm((gs2 - gs1 * gs1 / cd).reshape(b, n))
        zero = torch.zeros_like(q_mu)
        # logits = (raw - (cd qmu) kmu) / (qn kn tau)
        qv = torch.stack([1.0 / (q_norm * tau), cd * q_mu, zero, zero], -1)
        kv = torch.stack([1.0 / k_norm, k_mu, zero, zero], 1)
    else:
        fp = _pad_hw(f, 1)
        gp = _pad_hw(g, 1)
        f_bar = _shift_means(fp, 3, h, w)
        g_bar = _shift_means(gp, 3, h, w)
        ca = _cross_map(fp, g_bar, 3, h, w).reshape(b, n)
        cb = _cross_map(gp, f_bar, 3, h, w).reshape(b, n)
        const = torch.einsum("bsc,bsc->b", f_bar, g_bar)
        aa = _cross_map(fp, f_bar, 3, h, w).reshape(b, n)
        bb = _cross_map(gp, g_bar, 3, h, w).reshape(b, n)
        q_norm = _safe_norm(fs2.reshape(b, n) - 2 * aa
                            + torch.einsum("bsc,bsc->b", f_bar, f_bar)[:, None])
        k_norm = _safe_norm(gs2.reshape(b, n) - 2 * bb
                            + torch.einsum("bsc,bsc->b", g_bar, g_bar)[:, None])
        zero = torch.zeros_like(ca)
        # logits = (raw - ca - cb + const) / (qn kn tau)
        qv = torch.stack([1.0 / (q_norm * tau), zero, -ca,
                          const[:, None].expand_as(ca)], -1)
        kv = torch.stack([1.0 / k_norm, zero, -cb, zero], 1)
    f3 = _row_stack3(f).reshape(b, n, 3 * c)
    g3 = _row_stack3(g).reshape(b, n, 3 * c)
    return f3.contiguous(), g3.contiguous(), qv.contiguous(), kv.contiguous()


def shift9_core_plain(f3, g3, v, qv, kv, w: int):
    """Plain PyTorch version of the kernel: (o (B, N, D), lse (B, N))."""
    s3 = torch.matmul(f3, g3.transpose(1, 2))            # (B, N, N)
    n = s3.shape[1]
    col = torch.arange(n, device=s3.device) % w
    fp = (col != w - 1).to(s3.dtype)                     # dx = +1 valid
    fm = (col != 0).to(s3.dtype)                         # dx = -1 valid
    plus = torch.zeros_like(s3)
    plus[:, :-1, :-1] = s3[:, 1:, 1:]                    # S3(i+1, j+1)
    minus = torch.zeros_like(s3)
    minus[:, 1:, 1:] = s3[:, :-1, :-1]                   # S3(i-1, j-1)
    raw = (s3 + fp[:, None] * fp[None, :] * plus
           + fm[:, None] * fm[None, :] * minus)
    qs, qmul, qadd, cadd = (qv[..., i:i + 1] for i in range(4))
    ks, kmul, kadd = (kv[:, i:i + 1, :] for i in range(3))
    logits = (raw - qmul * kmul + qadd + kadd + cadd) * qs * ks
    lse = torch.logsumexp(logits, dim=-1)
    o = torch.matmul(torch.exp(logits - lse[..., None]), v)
    return o, lse


def shift9_core_kernel(f3, g3, v, qv, kv, w: int):
    """Launches csrc/shift9_fwd.cu: (o (B, N, D), lse (B, N))."""
    lib = _build.library("shift9_fwd")
    b, n, c3 = f3.shape
    d = v.shape[-1]
    tile = lib.cocosnet_shift9_tile()
    if n % tile or tile % w or d > lib.cocosnet_shift9_max_d():
        raise ValueError(f"shift9 kernel takes N % {tile} == 0, W dividing "
                         f"{tile} and D <= {lib.cocosnet_shift9_max_d()}; "
                         f"got N={n}, W={w}, D={d}")
    for t in (f3, g3, v, qv, kv):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != f3.device:
            raise ValueError("shift9 kernel takes contiguous f32 tensors on "
                             "one device")
    o = torch.empty((b, n, d), dtype=torch.float32, device=f3.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=f3.device)
    with torch.cuda.device(f3.device):
        err = lib.cocosnet_shift9_fwd(
            f3.data_ptr(), g3.data_ptr(), v.data_ptr(), qv.data_ptr(),
            kv.data_ptr(), o.data_ptr(), lse.data_ptr(), b, n, c3, d, w,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "shift9_fwd")
    return o, lse


def attend_shift9(f: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                  tau: float, pono_c: bool = True) -> torch.Tensor:
    """Fused softmax(corr / tau) @ v over centered, L2-normalized 3x3-unfold
    descriptors of the raw (B, H, W, C) theta/phi features; v is (B, H*W, D).
    Returns (B, H*W, D) f32. CUDA tensors run the kernel, CPU tensors its
    plain version."""
    w = f.shape[2]
    f3, g3, qv, kv = shift9_inputs(f, g, tau, pono_c)
    v = v.float().contiguous()
    if f.is_cuda:
        o, _ = shift9_core_kernel(f3, g3, v, qv, kv, w)
        attend_shift9.launches += 1
        return o
    if f.device.type != "cpu":
        raise ValueError(f"attend_shift9: no kernel for device {f.device}")
    attend_shift9.plain_calls += 1
    return shift9_core_plain(f3, g3, v, qv, kv, w)[0]


attend_shift9.launches = 0
attend_shift9.plain_calls = 0
