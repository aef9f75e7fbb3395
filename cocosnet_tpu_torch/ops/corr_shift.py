"""Shift-decomposed correlation for 3x3-unfold patch descriptors, plain
PyTorch.

Counterpart of cocosnet_tpu/ops/corr_shift.py: the k*k-unfold descriptor
correlation is the base C-channel correlation summed over k*k diagonal
shifts, and the descriptor centering and L2 normalization are rank-1
corrections from per-position box sums. `attend_unfold` is the plain
reference that the shift9 kernel (ops/shift9.py) is held against; the box
statistics helpers feed that kernel's rank-1 terms.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

_EPS = sys.float_info.epsilon


def _pad_hw(x: torch.Tensor, p: int) -> torch.Tensor:
    """Zero-pad H and W of an NHWC tensor by p."""
    return F.pad(x, (0, 0, p, p, p, p))


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W) -> (B, H, W): sum over the k x k zero-padded neighborhood."""
    b, h, w = x.shape
    p = k // 2
    xp = F.pad(x, (p, p, p, p))
    out = xp[:, 0:h, 0:w]
    for dy in range(k):
        for dx in range(k):
            if dy or dx:
                out = out + xp[:, dy:dy + h, dx:dx + w]
    return out


def _safe_norm(sq: torch.Tensor) -> torch.Tensor:
    """sqrt(||x||^2 + 1e-24) + eps (models/correspondence.py descriptors)."""
    return torch.sqrt(torch.clamp(sq, min=0.0) + 1e-24) + _EPS


def _shift_means(fp: torch.Tensor, k: int, h: int, w: int) -> torch.Tensor:
    """Per-shift spatial means of the unfold descriptor: (B, k*k, C)."""
    n = h * w
    rows = [fp[:, dy:dy + h, dx:dx + w, :].sum(dim=(1, 2)) / n
            for dy in range(k) for dx in range(k)]
    return torch.stack(rows, dim=1)


def _cross_map(fp: torch.Tensor, means: torch.Tensor, k: int, h: int,
               w: int) -> torch.Tensor:
    """(B, H, W): desc_f(n) . mbar for per-shift mean vectors (B, k*k, C)."""
    out = 0.0
    i = 0
    for dy in range(k):
        for dx in range(k):
            out = out + torch.einsum("bhwc,bc->bhw",
                                     fp[:, dy:dy + h, dx:dx + w, :],
                                     means[:, i])
            i += 1
    return out


def _unfold_stats(f: torch.Tensor, k: int):
    """Per-position (sum, sumsq) of the k*k unfold descriptor entries."""
    return _box_sum(f.sum(dim=-1), k), _box_sum((f * f).sum(dim=-1), k)


def attend_unfold(f: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                  tau: float, match_kernel: int = 3, pono_c: bool = True,
                  row_chunk: int = 8) -> torch.Tensor:
    """softmax_m(corr(n, m) / tau) @ v over centered, L2-normalized
    match_kernel-unfold descriptors of f (queries) and g (keys).

    f, g: (B, H, W, C) raw theta/phi features; v: (B, H*W, D). Returns
    (B, H*W, D) f32. Query rows stream in chunks of `row_chunk` image rows.
    """
    k = match_kernel
    b, h, w, c = f.shape
    n = h * w
    cd = c * k * k
    p = k // 2
    hp, wp = h + 2 * p, w + 2 * p
    f = f.float()
    g = g.float()
    v = v.float()

    fp = _pad_hw(f, p)
    gp = _pad_hw(g, p)
    g_flat = gp.reshape(b, hp * wp, c)
    fs1, fs2 = _unfold_stats(f, k)
    gs1, gs2 = _unfold_stats(g, k)

    if pono_c:
        q_c1 = (fs1 / cd).reshape(b, n)
        k_mu = (gs1 / cd).reshape(b, n)
        q_norm = _safe_norm((fs2 - fs1 * fs1 / cd).reshape(b, n))
        k_norm = _safe_norm((gs2 - gs1 * gs1 / cd).reshape(b, n))

        def correct(raw, qc, qn):
            adj = raw - cd * qc[..., None] * k_mu[:, None, :]
            return adj / (qn[..., None] * k_norm[:, None, :])
    else:
        f_bar = _shift_means(fp, k, h, w)
        g_bar = _shift_means(gp, k, h, w)
        q_c1 = _cross_map(fp, g_bar, k, h, w).reshape(b, n)
        cb = _cross_map(gp, f_bar, k, h, w).reshape(b, n)
        const = torch.einsum("bsc,bsc->b", f_bar, g_bar)
        aa = _cross_map(fp, f_bar, k, h, w).reshape(b, n)
        bb = _cross_map(gp, g_bar, k, h, w).reshape(b, n)
        fbar_sq = torch.einsum("bsc,bsc->b", f_bar, f_bar)
        gbar_sq = torch.einsum("bsc,bsc->b", g_bar, g_bar)
        q_norm = _safe_norm(fs2.reshape(b, n) - 2 * aa + fbar_sq[:, None])
        k_norm = _safe_norm(gs2.reshape(b, n) - 2 * bb + gbar_sq[:, None])

        def correct(raw, qc, qn):
            adj = raw - qc[..., None] - cb[:, None, :] + const[:, None, None]
            return adj / (qn[..., None] * k_norm[:, None, :])

    r = row_chunk
    while h % r != 0:
        r -= 1
    outs = []
    for i in range(h // r):
        f_blk = fp[:, i * r: i * r + r + 2 * p].reshape(b, -1, c)
        s = torch.matmul(f_blk, g_flat.transpose(1, 2))
        s5 = s.reshape(b, r + 2 * p, wp, hp, wp)
        raw = 0.0
        for dy in range(k):
            for dx in range(k):
                raw = raw + s5[:, dy:dy + r, dx:dx + w, dy:dy + h, dx:dx + w]
        raw = raw.reshape(b, r * w, n)
        qc = q_c1.reshape(b, h, w)[:, i * r:(i + 1) * r].reshape(b, r * w)
        qn = q_norm.reshape(b, h, w)[:, i * r:(i + 1) * r].reshape(b, r * w)
        prob = torch.softmax(correct(raw, qc, qn) / tau, dim=-1)
        outs.append(torch.matmul(prob, v))
    return torch.cat(outs, dim=1)
