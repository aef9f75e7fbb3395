"""Contextual loss (reference ContextualLoss.py:83-137), counterpart of
cocosnet_tpu/losses/contextual.py.

Cosine-distance affinity between fake and exemplar VGG features:
  d     = 1 - X^T Y (after centering both by Y's mean), clamped at >= 0
  d_bar = d / (rowmin(d) + 1e-3)
  A     = exp((1 - d_bar) / h), row-normalized
  CX    = mean_i max_j A_ij;  loss = -log CX per sample.
The clamp keeps min(d) + 1e-3 positive against matmul rounding: without it
a cos rounded past 1 once turned the loss into inf / inf = NaN a few steps
into training (contextual.py:55-63).
"""

from __future__ import annotations

import sys

import torch

_EPS = sys.float_info.epsilon


def contextual_loss(x_features: torch.Tensor, y_features: torch.Tensor,
                    h: float = 0.1, feature_centering: bool = True,
                    pono: bool = False) -> torch.Tensor:
    """NHWC feature maps -> per-sample loss (B,)."""
    b, hh, ww, c = x_features.shape
    if feature_centering:
        if pono:   # Y's channel mean at each position
            y_mean = y_features.mean(dim=-1, keepdim=True)
        else:      # Y's per-channel global mean
            y_mean = y_features.mean(dim=(1, 2), keepdim=True)
        x_features = x_features - y_mean
        y_features = y_features - y_mean

    def flat_norm(f):
        norm = torch.sqrt((f * f).sum(dim=-1, keepdim=True) + 1e-24)
        return (f / (norm + _EPS)).reshape(b, -1, c)

    x = flat_norm(x_features)
    y = flat_norm(y_features)
    d = torch.clamp(1.0 - torch.matmul(x, y.transpose(1, 2)), min=0.0)
    d_norm = d / (d.min(dim=-1, keepdim=True).values + 1e-3)
    w = torch.exp((1.0 - d_norm) / h)
    # degenerate (near-zero) features: every w of a row may underflow
    a_ij = w / (w.sum(dim=-1, keepdim=True) + 1e-12)
    cx = a_ij.max(dim=-1).values.mean(dim=1)
    return -torch.log(torch.clamp(cx, min=1e-12))
