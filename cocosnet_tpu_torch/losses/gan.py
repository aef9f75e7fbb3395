"""GAN losses: hinge (default), ls, original (BCE with logits) and wgan,
multiscale-list aware; feature matching; the per-sample weighted L1 and
the MSE of the perceptual terms.

Counterpart of cocosnet_tpu/losses/gan.py (reference loss.py:15-97). Each
returns a scalar; the reference's per-sample-then-batch average equals a
plain mean for equal-sized patch maps.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch
import torch.nn.functional as F

Pred = Union[torch.Tensor, Sequence]


def _single_loss(x: torch.Tensor, target_is_real: bool,
                 for_discriminator: bool, gan_mode: str) -> torch.Tensor:
    x = x.float()
    if gan_mode == "original":
        target = torch.ones_like(x) if target_is_real else torch.zeros_like(x)
        return F.binary_cross_entropy_with_logits(x, target)
    if gan_mode == "ls":
        return ((x - (1.0 if target_is_real else 0.0)) ** 2).mean()
    if gan_mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return -torch.clamp(x - 1, max=0.0).mean()
            return -torch.clamp(-x - 1, max=0.0).mean()
        if not target_is_real:
            raise ValueError("the generator's hinge loss aims for real")
        return -x.mean()
    if gan_mode == "w":
        return -x.mean() if target_is_real else x.mean()
    raise ValueError(f"unknown gan_mode {gan_mode!r}")


def gan_loss(pred: Pred, target_is_real: bool, for_discriminator: bool,
             gan_mode: str = "hinge") -> torch.Tensor:
    """GANLoss.__call__ (loss.py:83-97): for a list input, each scale's
    last map (the logits), the per-scale losses averaged."""
    if isinstance(pred, (list, tuple)):
        total = 0.0
        for pred_i in pred:
            if isinstance(pred_i, (list, tuple)):
                pred_i = pred_i[-1]
            total = total + _single_loss(pred_i, target_is_real,
                                         for_discriminator, gan_mode)
        return total / len(pred)
    return _single_loss(pred, target_is_real, for_discriminator, gan_mode)


def feature_matching_loss(pred_fake: List[List[torch.Tensor]],
                          pred_real: List[List[torch.Tensor]]) -> torch.Tensor:
    """GAN_Feat: L1 between D's intermediate features of fake and (detached)
    real, every scale, the logit map excluded, summed and divided by num_D
    (pix2pix_model.py:236-246)."""
    loss = 0.0
    for pf, pr in zip(pred_fake, pred_real):
        for f, r in zip(pf[:-1], pr[:-1]):
            loss = loss + (f.float() - r.detach().float()).abs().mean()
    return loss / len(pred_fake)


def weighted_l1_loss(x: torch.Tensor, target: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """util/util.py:36-40: |x - t| scaled by per-sample weights, meaned."""
    return ((x.float() - target.float()).abs() * weights).mean()


def mse_loss(x: torch.Tensor, target=0.0) -> torch.Tensor:
    return ((x - target) ** 2).mean()
