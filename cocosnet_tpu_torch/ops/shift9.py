"""Fused 3x3-unfold correlation + softmax + warp (match_kernel=3), forward
and backward.

Counterpart of cocosnet_tpu/ops/pallas_shift9.py `attend_shift9`. The
wrapper prepares, in PyTorch, what the kernels consume (pallas_shift9.py:
407-472): the dy taps folded into channels (F3/G3, 3C wide) and the rank-1
centering/normalization terms qv (B, N, 4: qs, qmul, qadd, cadd) and
kv (B, 4, N: ks, kmul, kadd, 0), 1/tau folded into qs. The core is a
torch.autograd.Function: its forward runs the hand-written CUDA kernel
csrc/shift9_fwd.cu (S3 and P V on the tensor cores in 3xTF32, two
launches) on a CUDA tensor, or its plain PyTorch version
(`shift9_core_plain`) on a CPU tensor, and saves the row logsumexp; its
backward runs csrc/shift9_bwd.cu (dS3 and P materialized in scratch, then
three GEMMs, all on the tensor cores in 3xTF32), or `shift9_bwd_plain` on
the CPU. The
gradients of the raw features flow on through `shift9_inputs` by ordinary
autograd, as the JAX package's prep is XLA autodiff.
"""

from __future__ import annotations

import torch

from cocosnet_tpu_torch.ops import _build
from cocosnet_tpu_torch.ops.corr import _rows16
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


def _col_masks(n: int, w: int, device, dtype):
    """(n,) 0/1 masks of the dx = +1 and dx = -1 shifts: +1 is invalid at
    image column W-1, -1 at column 0 (the unfold's zero padding)."""
    col = torch.arange(n, device=device) % w
    return (col != w - 1).to(dtype), (col != 0).to(dtype)


def _shift_sum(s3: torch.Tensor, w: int) -> torch.Tensor:
    """raw(i, j) = S3 + m+ S3(i+1, j+1) + m- S3(i-1, j-1) on (B, N, N)."""
    fp, fm = _col_masks(s3.shape[1], w, s3.device, s3.dtype)
    plus = torch.zeros_like(s3)
    plus[:, :-1, :-1] = s3[:, 1:, 1:]
    minus = torch.zeros_like(s3)
    minus[:, 1:, 1:] = s3[:, :-1, :-1]
    return (s3 + fp[:, None] * fp[None, :] * plus
            + fm[:, None] * fm[None, :] * minus)


def _unshift_sum(da: torch.Tensor, w: int) -> torch.Tensor:
    """Adjoint of _shift_sum: dS3 = dA + (m+ dA)(i-1, j-1) + (m- dA)(i+1,
    j+1) (pallas_shift9.py:122-129)."""
    fp, fm = _col_masks(da.shape[1], w, da.device, da.dtype)
    back = da.clone()
    back[:, 1:, 1:] += (fp[:, None] * fp[None, :] * da)[:, :-1, :-1]
    back[:, :-1, :-1] += (fm[:, None] * fm[None, :] * da)[:, 1:, 1:]
    return back


def _logits(raw, qv, kv):
    qs, qmul, qadd, cadd = (qv[..., i:i + 1] for i in range(4))
    ks, kmul, kadd = (kv[:, i:i + 1, :] for i in range(3))
    return (raw - qmul * kmul + qadd + kadd + cadd) * qs * ks


def shift9_core_plain(f3, g3, v, qv, kv, w: int):
    """Plain PyTorch version of the forward kernel: (o (B, N, D),
    lse (B, N))."""
    logits = _logits(_shift_sum(torch.matmul(f3, g3.transpose(1, 2)), w),
                     qv, kv)
    lse = torch.logsumexp(logits, dim=-1)
    o = torch.matmul(torch.exp(logits - lse[..., None]), v)
    return o, lse


def shift9_bwd_plain(f3, g3, v, qv, kv, lse, go, dd, w: int):
    """Plain PyTorch version of the backward kernel, the math of
    pallas_shift9.py `_dq_kernel` and `_dk_kernel` on whole (B, N, N)
    matrices: from the saved lse, the output gradient go (B, N, D) and
    dd = rowsum(go * o) (B, N), returns dF3 (B, N, 3C), dqv (B, N, 4),
    dG3 (B, N, 3C), dkv (B, 4, N) and dV (B, N, D)."""
    logits = _logits(_shift_sum(torch.matmul(f3, g3.transpose(1, 2)), w),
                     qv, kv)
    p = torch.exp(logits - lse[..., None])
    gl = p * (torch.matmul(go, v.transpose(1, 2)) - dd[..., None])
    qs, qmul = qv[..., 0:1], qv[..., 1:2]
    ks, kmul = kv[:, 0:1, :], kv[:, 1:2, :]
    da = gl * qs * ks                                    # d(raw)
    gll = gl * logits
    dqadd = da.sum(-1)
    # the cadd gradient is qadd's (pallas_shift9.py:249)
    dqv = torch.stack([gll.sum(-1) / qs[..., 0], -(da * kmul).sum(-1),
                       dqadd, dqadd], -1)
    dkadd = da.sum(1)
    dkv = torch.stack([gll.sum(1) / ks[:, 0], -(da * qmul).sum(1), dkadd,
                       torch.zeros_like(dkadd)], 1)
    ds3 = _unshift_sum(da, w)
    df3 = torch.matmul(ds3, g3)
    dg3 = torch.matmul(ds3.transpose(1, 2), f3)
    dv = torch.matmul(p.transpose(1, 2), go)
    return df3, dqv, dg3, dkv, dv


def _check_f32(what, *ts):
    for t in ts:
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != ts[0].device:
            raise ValueError(f"{what} takes contiguous f32 tensors on one "
                             "device")


def fwd_parts(blocks: int, regions: int, sms: int) -> int:
    """How many parts the forward kernel cuts its key regions into, each
    part a block of its own per query tile: of the counts 1 .. 4 that
    leave no part empty, the one whose blocks (`blocks` a part, one an SM)
    fill the last of their waves on `sms` SMs best, the fewest on a tie."""
    best, fill = 1, 0.0
    for parts in range(1, min(4, regions) + 1):
        if -(-regions // -(-regions // parts)) != parts:
            continue   # a part would be empty
        n = blocks * parts
        f = n / (-(-n // sms) * sms)
        if f > fill + 1e-9:
            best, fill = parts, f
    return best


def shift9_fwd_parts(b: int, n: int, d: int, device) -> int:
    """fwd_parts at (B, N, D) on the card of `device`."""
    lib = _build.library("shift9_fwd")
    return fwd_parts(lib.cocosnet_shift9_fwd_blocks(b, n, d),
                     lib.cocosnet_shift9_fwd_key_regions(n),
                     torch.cuda.get_device_properties(
                         device).multi_processor_count)


def shift9_core_kernel(f3, g3, v, qv, kv, w: int):
    """Launches csrc/shift9_fwd.cu (a flash forward on the tensor cores in
    3xTF32, its key regions cut into the parts that fill whole waves, then
    a combine of the parts) on rows padded to 16 bytes, with the parts'
    scratch: (o (B, N, D), lse (B, N))."""
    lib = _build.library("shift9_fwd")
    b, n, c3 = f3.shape
    d = v.shape[-1]
    if n % w or d > lib.cocosnet_shift9_max_d():
        raise ValueError(f"shift9 kernel takes N = H * W and D <= "
                         f"{lib.cocosnet_shift9_max_d()}; got N={n}, W={w}, "
                         f"D={d}")
    if b > 65535:
        raise ValueError(f"shift9 kernel takes B <= 65535 (its grid's second "
                         f"dimension); got B={b}")
    _check_f32("shift9 kernel", f3, g3, v, qv, kv)
    parts = shift9_fwd_parts(b, n, d, f3.device)
    ops = [_rows16(t) for t in (f3, g3, v)]
    o = torch.empty((b, n, d), dtype=torch.float32, device=f3.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=f3.device)
    opart = torch.empty((parts, b, n, d), dtype=torch.float32,
                        device=f3.device)
    ml = torch.empty((parts, b, n, 2), dtype=torch.float32, device=f3.device)
    with torch.cuda.device(f3.device):
        err = lib.cocosnet_shift9_fwd(
            *(t.data_ptr() for t in (*ops, qv, kv, o, lse, opart, ml)),
            b, n, c3, d, w, parts, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "shift9_fwd")
    return o, lse


def shift9_bwd_kernel(f3, g3, v, qv, kv, lse, go, dd, w: int):
    """Launches csrc/shift9_bwd.cu (scores, a reduce of the side gradients,
    then dF3, dG3 and dV, on the tensor cores in 3xTF32) with its dS3 and P
    scratch (B, Np, Np) and per-tile partials: the outputs of
    shift9_bwd_plain."""
    lib = _build.library("shift9_bwd")
    b, n, c3 = f3.shape
    d = v.shape[-1]
    if n % w:
        raise ValueError(f"shift9 backward kernel takes N = H * W; got N={n},"
                         f" W={w}")
    if b > 65535:
        raise ValueError(f"shift9 backward kernel takes B <= 65535 (its "
                         f"grid's third dimension); got B={b}")
    # the key side's rank-1 terms per position, its unused fourth row zero
    kvt = torch.cat([kv[:, :3].transpose(1, 2),
                     torch.zeros_like(kv[:, :1].transpose(1, 2))],
                    -1).contiguous()
    _check_f32("shift9 backward kernel", f3, g3, v, qv, kvt, lse, go, dd)
    tile = lib.cocosnet_shift9_bwd_tile()
    npad = -(-n // tile) * tile
    tiles = -(-npad // lib.cocosnet_shift9_bwd_owned())
    ops = [_rows16(t) for t in (f3, g3, v, go)]
    df3 = torch.empty_like(f3)
    dg3 = torch.empty_like(g3)
    dv = torch.empty_like(v)
    dq3 = torch.empty((b, n, 3), dtype=torch.float32, device=f3.device)
    dk3 = torch.empty_like(dq3)
    p = torch.empty((b, npad, npad), dtype=torch.float32, device=f3.device)
    ds = torch.empty_like(p)
    qpart = torch.empty((b, tiles, n, 3), dtype=torch.float32,
                        device=f3.device)
    kpart = torch.empty_like(qpart)
    with torch.cuda.device(f3.device):
        err = lib.cocosnet_shift9_bwd(
            *(t.data_ptr() for t in (*ops, qv, kvt, lse, dd, df3, dq3, dg3,
                                     dk3, dv, p, ds, qpart, kpart)),
            b, n, c3, d, w,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "shift9_bwd")
    dqv = torch.cat([dq3, dq3[..., 2:3]], -1)
    dkv = torch.cat([dk3, torch.zeros_like(dk3[..., :1])], -1).transpose(1, 2)
    return df3, dqv, dg3, dkv.contiguous(), dv


def attend_shift9_backward(f3, g3, v, qv, kv, lse, go, dd, w: int):
    """The gradients of the shift9 core (see shift9_bwd_plain): CUDA
    tensors launch csrc/shift9_bwd.cu, CPU tensors run the plain
    version."""
    if f3.is_cuda:
        res = shift9_bwd_kernel(f3, g3, v, qv, kv, lse, go, dd, w)
        attend_shift9_backward.launches += 1
        return res
    if f3.device.type != "cpu":
        raise ValueError(f"attend_shift9: no kernel for device {f3.device}")
    attend_shift9_backward.plain_calls += 1
    return shift9_bwd_plain(f3, g3, v, qv, kv, lse, go, dd, w)


class _Shift9Core(torch.autograd.Function):
    """o = softmax(logits) @ v of the kernel's inputs, with the backward
    on the backward kernel."""

    @staticmethod
    def forward(ctx, f3, g3, v, qv, kv, w):
        if f3.is_cuda:
            o, lse = shift9_core_kernel(f3, g3, v, qv, kv, w)
            attend_shift9.launches += 1
        else:
            o, lse = shift9_core_plain(f3, g3, v, qv, kv, w)
            attend_shift9.plain_calls += 1
        ctx.save_for_backward(f3, g3, v, qv, kv, o, lse)
        ctx.w = w
        return o

    @staticmethod
    def backward(ctx, go):
        f3, g3, v, qv, kv, o, lse = ctx.saved_tensors
        go = go.float().contiguous()
        dd = (go * o).sum(-1)
        df3, dqv, dg3, dkv, dv = attend_shift9_backward(
            f3, g3, v, qv, kv, lse, go, dd, ctx.w)
        return df3, dg3, dv, dqv, dkv, None


def attend_shift9(f: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                  tau: float, pono_c: bool = True) -> torch.Tensor:
    """Fused softmax(corr / tau) @ v over centered, L2-normalized 3x3-unfold
    descriptors of the raw (B, H, W, C) theta/phi features; v is (B, H*W, D).
    Returns (B, H*W, D) f32, differentiable in f, g and v. CUDA tensors run
    the kernels, CPU tensors their plain versions."""
    if f.device.type not in ("cuda", "cpu"):
        raise ValueError(f"attend_shift9: no kernel for device {f.device}")
    w = f.shape[2]
    f3, g3, qv, kv = shift9_inputs(f, g, tau, pono_c)
    return _Shift9Core.apply(f3, g3, v.float().contiguous(), qv, kv, w)


for _fn in (attend_shift9, attend_shift9_backward):
    _fn.launches = 0
    _fn.plain_calls = 0
