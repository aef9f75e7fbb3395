"""VGG perceptual losses (reference loss.py:101-120 and the fm/perc terms
of pix2pix_model.py:248-257). Counterpart of
cocosnet_tpu/losses/perceptual.py; the train step assembles its weighted
per-sample variant in pix2pix.compute_generator_losses."""

from __future__ import annotations

from typing import Sequence

import torch

VGG_FM_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def vgg_feature_matching(x_feats: Sequence[torch.Tensor],
                         y_feats: Sequence[torch.Tensor],
                         weights: Sequence[float] = VGG_FM_WEIGHTS
                         ) -> torch.Tensor:
    """VGGLoss.forward (loss.py:112-120): weighted L1 over feature slices,
    targets detached."""
    loss = 0.0
    for w, xf, yf in zip(weights, x_feats, y_feats):
        loss = loss + w * (xf - yf.detach()).abs().mean()
    return loss


def perceptual_mse(x_feat: torch.Tensor, y_feat: torch.Tensor) -> torch.Tensor:
    """The relu5_2 / relu4_2 MSE perceptual term (pix2pix_model.py:256)."""
    return ((x_feat - y_feat.detach()) ** 2).mean()
