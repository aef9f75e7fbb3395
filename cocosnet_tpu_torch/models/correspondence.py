"""Cross-domain correspondence network, match_kernel 3 (the flagship) and 1.

Counterpart of cocosnet_tpu/models/correspondence.py `CorrespondenceNet`:
two domain adaptors, the channel L2 norm, the (maskmix) residual stack, the
theta/phi 1x1 convs and one fused correlation + softmax + warp whose values
are the exemplar colors and, with the direct mask loss type, the
exemplar's one-hot map. In train mode, given the real image, it also
returns the domain-alignment loss `loss_novgg_featpair`
(correspondence.py:149-153).

The warp, by match_kernel, as the JAX package routes it
(correspondence.py:241-246, :313-319):
- 3: the 3x3-unfold correlation, ops/shift9.attend_shift9 (its kernels
  forward and backward, in inference and training); with
  `opt.use_pallas` False, the library route ops/corr_shift.attend_unfold;
- 1: dense 256-dim descriptors, centered (over channels with PONO_C, over
  positions without) and L2-normalized in f32, then ops/corr.attend_corr
  (its kernels) in inference; in training the library route
  ops/correlation.attend, unless the environment sets
  COCOSNET_PALLAS_MK1_TRAIN=1 (read at each call), which puts training on
  attend_corr's kernels forward and backward; `opt.use_pallas` False
  takes the library route in inference and training, whatever the
  environment says.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import torch
import torch.nn as tnn

from cocosnet_tpu_torch.config import Options
from cocosnet_tpu_torch.models.generator import AdaptiveFeatureGenerator
from cocosnet_tpu_torch.nn.blocks import ResidualBlock
from cocosnet_tpu_torch.nn.layers import Conv2d, OneHotLabels
from cocosnet_tpu_torch.ops.corr import attend_corr
from cocosnet_tpu_torch.ops.corr_shift import attend_unfold
from cocosnet_tpu_torch.ops.correlation import attend
from cocosnet_tpu_torch.ops.image import (avg_pool, resize_nearest,
                                          upsample_nearest)
from cocosnet_tpu_torch.ops.shift9 import attend_shift9

_EPS = sys.float_info.epsilon
# "1" puts match_kernel=1 training on attend_corr's kernels
MK1_TRAIN_ENV = "COCOSNET_PALLAS_MK1_TRAIN"


def safe_l2_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(x^2) + tiny) over the last dim in f32: a finite gradient at
    an exactly-zero vector."""
    x = x.float()
    return torch.sqrt((x * x).sum(dim=-1, keepdim=True) + 1e-24)


def feature_normalize(x: torch.Tensor) -> torch.Tensor:
    """L2 normalize over the channel dim (NHWC), f32."""
    x = x.float()
    return x / (safe_l2_norm(x) + _EPS)


class CorrespondenceNet(tnn.Module):
    def __init__(self, opt: Options):
        super().__init__()
        self.opt = opt
        self.adaptive_model_seg = AdaptiveFeatureGenerator(opt,
                                                           opt.semantic_nc)
        self.adaptive_model_img = AdaptiveFeatureGenerator(opt, 3)
        channels = 4 * opt.ngf + (opt.semantic_nc if opt.maskmix else 0)
        self.layer = tnn.Sequential(*[ResidualBlock(channels)
                                      for _ in range(4)])
        self.theta = Conv2d(channels, 256, 1)
        self.phi = Conv2d(channels, 256, 1)

    def _descriptor(self, y: torch.Tensor) -> torch.Tensor:
        """match_kernel=1 descriptors (B, N, 256) of a theta/phi output:
        centered over channels (PONO_C) or over positions, L2-normalized,
        f32 (correspondence.py:272-289)."""
        b, h, w, c = y.shape
        desc = y.float().reshape(b, h * w, c)
        desc = desc - desc.mean(dim=-1 if self.opt.PONO_C else 1,
                                keepdim=True)
        return desc / (safe_l2_norm(desc) + _EPS)

    def forward(self, ref_img: torch.Tensor, seg_map: torch.Tensor,
                ref_seg_map: torch.Tensor, temperature: float = 0.01,
                seg_label: Optional[torch.Tensor] = None,
                real_img: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """ref_img (B, H, W, 3); seg_map / ref_seg_map (B, H, W,
        semantic_nc) one-hot maps; seg_label, when given, the integer map
        whose one-hot IS seg_map: the seg adaptor's first conv then reads
        the labels (conv3x3_onehot) instead of the dense one-hot; real_img
        (B, H, W, 3), in train mode, the image the label map depicts."""
        opt = self.opt
        out: Dict[str, torch.Tensor] = {}
        b, ih, iw, _ = ref_img.shape
        fh, fw = ih // opt.down, iw // opt.down
        n = fh * fw

        adaptor_x = seg_map
        if seg_label is not None:
            adaptor_x = OneHotLabels(seg_label, opt.semantic_nc,
                                     seg_map.dtype)
        feat_seg = feature_normalize(self.adaptive_model_seg(adaptor_x,
                                                             seg_map))
        feat_img = feature_normalize(self.adaptive_model_img(ref_img,
                                                             ref_img))
        out["adaptive_feature_seg"] = feat_seg
        out["adaptive_feature_img"] = feat_img
        if (self.training and opt.novgg_featpair > 0
                and real_img is not None):
            feat_pair = feature_normalize(self.adaptive_model_img(real_img,
                                                                  real_img))
            out["loss_novgg_featpair"] = ((feat_seg - feat_pair).abs().mean()
                                          * opt.novgg_featpair)

        seg_small = resize_nearest(seg_map, fh, fw)
        ref_seg_small = resize_nearest(ref_seg_map, fh, fw)
        if opt.maskmix:
            cont_features = self.layer(torch.cat([feat_seg, seg_small], -1))
            ref_features = self.layer(torch.cat([feat_img, ref_seg_small],
                                                -1))
        else:
            cont_features = self.layer(feat_seg)
            ref_features = self.layer(feat_img)

        # descriptors stay f32: tau = 0.01 amplifies their error 100x
        y_theta = self.theta(cont_features).float()
        y_phi = self.phi(ref_features).float()

        ref_v = avg_pool(ref_img, opt.down).reshape(b, n, 3)
        need_direct_mask = (opt.warp_mask_losstype == "direct"
                            or opt.show_warpmask)
        values = [ref_v]
        if need_direct_mask:
            values.append(ref_seg_small.reshape(b, n, -1))
        v = torch.cat(values, -1)
        if opt.match_kernel == 1:
            theta = self._descriptor(y_theta)
            phi = self._descriptor(y_phi)
            if opt.use_pallas and not (
                    self.training and os.environ.get(MK1_TRAIN_ENV) != "1"):
                row_out = attend_corr(theta, phi, v, temperature)
            else:
                row_out = attend(theta, phi, v, temperature)
        elif opt.use_pallas:
            row_out = attend_shift9(y_theta, y_phi, v, temperature,
                                    opt.PONO_C)
        else:
            row_out = attend_unfold(y_theta, y_phi, v, temperature,
                                    opt.match_kernel, opt.PONO_C)
        y = row_out[..., :3].reshape(b, fh, fw, 3)
        out["warp_out"] = upsample_nearest(y, opt.down)
        if need_direct_mask:
            out["warp_mask"] = row_out[..., 3:].reshape(b, fh, fw, -1)
        return out
