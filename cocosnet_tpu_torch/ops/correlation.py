"""Dense-correspondence attention on the library route: out = softmax(q k^T /
tau) v with q (B, N, C), k (B, M, C), v (B, M, D).

Counterpart of cocosnet_tpu/ops/correlation.py `attend_reference`,
`attend_chunked` and the XLA side of `attend`: torch.matmul and softmax, as
the JAX package leaves them to XLA. The hand-written kernel route is
ops/corr.attend_corr. A float32 product here runs in full f32 unless the
caller turns TF32 on (torch.backends.cuda.matmul.allow_tf32): tau = 0.01
amplifies logit error 100x.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def attend_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     tau: float) -> torch.Tensor:
    """softmax(q k^T / tau, dim=-1) v in f32, with the whole (B, N, M)
    logits matrix."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) / tau
    return torch.matmul(torch.softmax(s, dim=-1), v.float())


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   tau: float, chunk: int = 512) -> torch.Tensor:
    """attend_reference over blocks of `chunk` query rows, each block
    checkpointed, so at most (B, chunk, M) logits are live in the forward
    and again in the backward, which recomputes them (jax.checkpoint over
    lax.map in the JAX package). N not a multiple of the chunk takes the
    dense form, as there."""
    n = q.shape[1]
    chunk = min(chunk, n)
    if n % chunk:
        return attend_reference(q, k, v, tau)
    return torch.cat([checkpoint(attend_reference, q[:, i:i + chunk], k, v,
                                 tau, use_reentrant=False)
                      for i in range(0, n, chunk)], dim=1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           tau: float) -> torch.Tensor:
    """The chunked form from 2^26 logits (256 MB of f32) up, the dense form
    below."""
    b, n, _ = q.shape
    if b * n * k.shape[1] >= (1 << 26):
        return attend_chunked(q, k, v, tau)
    return attend_reference(q, k, v, tau)
