"""Spatial-parallel (SP) correlation: the query rows of the match_kernel
unfold correlation shared out over the ranks of the mesh's model group.

Counterpart of cocosnet_tpu/ops/corr_sp.py. The JAX package shards the
feature maps themselves over the `model` axis, all-gathers the keys and
trades the one-row halos of the queries by ppermute. In the port the
network around the correlation is replicated over the model group (every
rank of it holds the same weights and the same batch), so `attend_sp`
takes the whole (B, H, W, C) maps and (B, H W, D) values on every rank of
the group and returns the whole output on every rank. Rank k of m computes
the output rows of image rows [k H/m, (k + 1) H/m) against every key:
its rows of the kernel's row stack f3 already hold their +-1-row halo, and
the query statistics are per position. Two autograd Functions bracket the
work:

    forward   identity in               all_gather of the rows out
    backward  all_reduce(sum) of the    this rank's rows of the
              input gradients           (replicated) output gradient

so a rank's gradient to the replicated parameters upstream is the
single-device gradient: each rank's input gradient is its rows' share,
and the sum over the group is the whole. Only all_reduce and all_gather
run, which both NCCL and gloo take on CUDA tensors.

Routes, as cocosnet_tpu/models/correspondence.py:227-301 takes them:
match_kernel 3 with use_pallas runs the shift9 core at nq = H W / m
queries against nk = H W keys (ops/shift9._Shift9Core: the kernels on a
CUDA tensor, their plain versions on a CPU tensor, a raise elsewhere);
match_kernel 3 without use_pallas and match_kernel 1 run `attend_unfold_sp`,
the streaming unfold (ops/corr_shift.attend_unfold over the shard's query
rows) with library ops, at k = 1 from per-position statistics (the JAX
package runs no Pallas kernel there either). Only PONO_C centering has an
SP form, as in the JAX package; spatial centering raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cocosnet_tpu_torch import mesh as M
from cocosnet_tpu_torch.ops.corr_shift import attend_unfold
from cocosnet_tpu_torch.ops.shift9 import _Shift9Core, shift9_inputs


class _ModelIn(torch.autograd.Function):
    """Identity forward; backward sums each input gradient over the model
    group (each rank's is its query rows' share)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads:
            if g is not None:
                g = g.contiguous().clone()
                dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


class _GatherRows(torch.autograd.Function):
    """all_gather of the ranks' (B, rows, D) shards along the rows;
    backward takes this rank's rows of the output gradient."""

    @staticmethod
    def forward(ctx, shard, group, m, k):
        ctx.rows, ctx.k = shard.shape[1], k
        parts = [torch.empty_like(shard) for _ in range(m)]
        dist.all_gather(parts, shard.contiguous(), group=group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, go):
        r = ctx.rows
        return go[:, ctx.k * r:(ctx.k + 1) * r].contiguous(), None, None, None


def shift9_sp_supported(hl: int, w: int, c: int) -> bool:
    """The shard shapes the shift9 kernels take: whole image rows, at
    least one (the kernels cut their tiles from positions, not rows, so
    any hl, W and C the square form takes; pallas-side lane and block
    rules, shift9_sp_supported of the JAX package, are the TPU's)."""
    return hl >= 1 and w >= 1 and c >= 1


def attend_shift9_sp(f: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                     tau: float, rows: slice,
                     pono_c: bool = True) -> torch.Tensor:
    """The shift9 core on the query rows `rows` (positions, whole image
    rows) of the whole maps f, g (B, H, W, C) against every key: (B, rows,
    D). Differentiable in f, g and v; the gradients are this shard's
    share."""
    if not pono_c:
        raise NotImplementedError(
            "attend_shift9_sp implements PONO_C centering (the flagship "
            "config); use attend_shift9 for spatial centering")
    b, h, w, c = f.shape
    if rows.start % w or rows.stop % w \
            or not shift9_sp_supported((rows.stop - rows.start) // w, w, c):
        raise ValueError(f"attend_shift9_sp: query rows {rows} are not "
                         f"whole image rows of width {w}")
    f3, g3, qv, kv = shift9_inputs(f, g, tau, pono_c)
    return _Shift9Core.apply(f3[:, rows].contiguous(), g3,
                             v.float().contiguous(),
                             qv[:, rows].contiguous(), kv, w)


def attend_unfold_sp(f: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                     tau: float, rows: slice, match_kernel: int = 3,
                     pono_c: bool = True) -> torch.Tensor:
    """The streaming unfold correlation (library ops) on the query rows
    `rows` of the whole maps against every key: (B, rows, D)."""
    if not pono_c:
        raise NotImplementedError(
            "attend_unfold_sp implements PONO_C centering (the flagship "
            "config); use the replicated attend_unfold for spatial "
            "centering")
    w = f.shape[2]
    return attend_unfold(f, g, v, tau, match_kernel, pono_c,
                         rows=(rows.start // w, rows.stop // w))


def attend_sp(q_feat: torch.Tensor, k_feat: torch.Tensor, v: torch.Tensor,
              tau: float, mesh: M.Mesh = None, match_kernel: int = 3,
              pono_c: bool = True, use_pallas: bool = True,
              model: int = 0) -> torch.Tensor:
    """Spatial-parallel attend on the whole maps, on every rank of the
    model group: q_feat, k_feat (B, H, W, C) raw theta/phi features, v (B,
    H W, D). Returns (B, H W, D) f32, the single-device attend_shift9 /
    attend_unfold result, on every rank. Requires PONO_C and H % m == 0
    for the model group's size m (the registered mesh's; `model` is the
    size the caller expects, checked against it)."""
    if not pono_c:
        raise NotImplementedError(
            "spatial-parallel correlation implements PONO_C centering (the "
            "flagship config); run replicated for spatial centering")
    mesh = mesh if mesh is not None else M.global_mesh()
    m = mesh.model
    if model > 1 and model != m:
        raise ValueError(f"the correlation asks for a model group of "
                         f"{model}; the registered mesh has {m} (create and "
                         f"register it with mesh.create_mesh, "
                         f"set_global_mesh)")
    b, h, w, c = q_feat.shape
    if h % m != 0:
        raise ValueError(f"feature rows H={h} must divide the model axis {m}")
    k = mesh.model_rank
    hl = h // m
    rows = slice(k * hl * w, (k + 1) * hl * w)
    f, g, v = q_feat.float(), k_feat.float(), v.float()
    if mesh.model_group is not None:
        f, g, v = _ModelIn.apply(mesh.model_group, f, g, v)
    if use_pallas and match_kernel == 3:
        out = attend_shift9_sp(f, g, v, tau, rows, pono_c)
    else:
        out = attend_unfold_sp(f, g, v, tau, rows, match_kernel, pono_c)
    if mesh.model_group is None:
        return out
    return _GatherRows.apply(out, mesh.model_group, m, k)
