"""Cross-domain correspondence network, at any odd match_kernel (3 is the
flagship).

Counterpart of cocosnet_tpu/models/correspondence.py `CorrespondenceNet`:
two domain adaptors, the channel L2 norm, the (maskmix) residual stack, the
theta/phi 1x1 convs and one fused correlation + softmax + warp whose values
are the exemplar colors (avg-pooled to the feature grid and upsampled back
nearest or, with --warp_bilinear, bilinear; with --warp_patch its d x d
patches, folded back) and, with the direct mask loss type, the exemplar's
one-hot map (correspondence.py:327-356). The cycle warps run the same
correlation with query and key swapped (a column softmax): with the cycle
mask loss type the label map warped to the exemplar and back
(`warp_mask`); with --warp_cycle_w the warp carried back to the exemplar
(`warp_cycle`) and, with --two_cycle, the real image to the exemplar and
back (`warp_i2r`, `warp_i2r2i`), one call per call of the JAX package, in
its order (correspondence.py:358-382). In train mode, given the real
image, it also returns the domain-alignment loss `loss_novgg_featpair`
(correspondence.py:149-153).

The branches off the flagship (correspondence.py:122-186, :195-225):
--mask_noise adds N(0, 0.1^2) to the label map's nonzero entries in
training (the seg adaptor then reads the dense noised map, never the
label ids); --noise_for_mask, in eval or past --mask_epoch in training,
replaces the exemplar's mask in the maskmix stack by N(0, 0.01^2);
--use_coordconv appends the xx, yy, rr channels to both adaptive
features. The draws are inputs (`seg_noise`, `ref_seg_noise`: standard
normal, of the label map's and the exemplar's feature-grid mask's
shapes), drawn by the caller from its own generator
(pix2pix.draw_noise), so that a recomputed forward sees the same noise
and a test can feed the JAX package's draws.

The warp, by match_kernel, as the JAX package routes it
(correspondence.py:241-246, :313-319):
- WTA_scale_weight != 1 or return_corr: the explicit (B, N, M) matrix of
  the centered, L2-normalized (unfold) descriptors in f32, winner-take-all
  scaled (ops/correlation.wta_scale), over tau; return_corr returns it as
  `corr`, else row and column softmaxes warp with plain products (JAX
  leaves this path to XLA, so torch.matmul serves);
- 3: the 3x3-unfold correlation, ops/shift9.attend_shift9 (its kernels
  forward and backward, in inference and training); with
  `opt.use_pallas` False, the library route ops/corr_shift.attend_unfold;
- any other odd k > 1: ops/corr_shift.attend_unfold;
- 1: dense 256-dim descriptors, centered (over channels with PONO_C, over
  positions without) and L2-normalized in f32, then ops/corr.attend_corr
  (its kernels) in inference; in training the library route
  ops/correlation.attend, unless the environment sets
  COCOSNET_PALLAS_MK1_TRAIN=1 (read at each call), which puts training on
  attend_corr's kernels forward and backward; `opt.use_pallas` False
  takes the library route in inference and training, whatever the
  environment says.
With opt.mesh_model > 1 the correlation's query rows are shared out over
the mesh's model group (ops/corr_sp.attend_sp; correspondence.py:247-256,
:265-286): at match_kernel 3 always (its kernels at nq != nk, or the
streaming unfold without use_pallas), at match_kernel 1 with PONO_C (the
unfold at k = 1); match_kernel 1 without PONO_C warns and runs the dense
path replicated on every rank, as the JAX package does (:287-301).
"""

from __future__ import annotations

import os
import sys
import warnings
from typing import Dict, Optional

import torch
import torch.nn as tnn

from cocosnet_tpu_torch.config import Options
from cocosnet_tpu_torch.models.generator import AdaptiveFeatureGenerator
from cocosnet_tpu_torch.nn.blocks import ResidualBlock
from cocosnet_tpu_torch.nn.layers import Conv2d, OneHotLabels
from cocosnet_tpu_torch.ops.corr import attend_corr
from cocosnet_tpu_torch.ops.corr_sp import attend_sp
from cocosnet_tpu_torch.ops.corr_shift import attend_unfold
from cocosnet_tpu_torch.ops.correlation import attend, wta_scale
from cocosnet_tpu_torch.ops.image import (avg_pool, patches_to_space,
                                          resize_nearest, space_to_patches,
                                          unfold_descriptors,
                                          upsample_bilinear, upsample_nearest)
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


def add_coords(x: torch.Tensor) -> torch.Tensor:
    """CoordConv's xx, yy, rr channels appended (correspondence.py:66-76):
    xx, yy in [-1, 1] along W and H, rr their radius, in x's dtype."""
    n, h, w, _ = x.shape
    xx = (torch.arange(w, dtype=x.dtype, device=x.device) / (w - 1))
    yy = (torch.arange(h, dtype=x.dtype, device=x.device) / (h - 1))
    xx = (2 * xx - 1)[None, None, :, None].expand(n, h, w, 1)
    yy = (2 * yy - 1)[None, :, None, None].expand(n, h, w, 1)
    rr = torch.sqrt(xx ** 2 + yy ** 2)
    return torch.cat([x, xx, yy, rr], dim=-1)


# the fixed draws of eval calls without a generator, by shape and device:
# made once, so that a serving CUDA graph captured after its warm-up call
# copies nothing from the host
_FIXED_DRAWS: Dict = {}


def _fixed_draw(like: torch.Tensor) -> torch.Tensor:
    """A standard-normal draw of like's shape from seed 0, on like's device:
    an eval call's --noise_for_mask without a generator, as JAX's
    PRNGKey(0) fallback (correspondence.py:182-183)."""
    key = (tuple(like.shape), like.device)
    if key not in _FIXED_DRAWS:
        _FIXED_DRAWS[key] = torch.randn(
            like.shape, generator=torch.Generator().manual_seed(0)).to(
                like.device)
    return _FIXED_DRAWS[key]


def uses_ref_noise(opt: Options, train: bool) -> bool:
    """--noise_for_mask replaces the exemplar's mask: in eval, and in
    training past --mask_epoch (correspondence.py:167-168)."""
    return bool(opt.maskmix and opt.noise_for_mask
                and (not train or opt.epoch > opt.mask_epoch))


class CorrespondenceNet(tnn.Module):
    def __init__(self, opt: Options):
        super().__init__()
        self.opt = opt
        self.adaptive_model_seg = AdaptiveFeatureGenerator(opt,
                                                           opt.semantic_nc)
        self.adaptive_model_img = AdaptiveFeatureGenerator(opt, 3)
        channels = (4 * opt.ngf + (3 if opt.use_coordconv else 0)
                    + (opt.semantic_nc if opt.maskmix else 0))
        self.layer = tnn.Sequential(*[ResidualBlock(channels)
                                      for _ in range(4)])
        self.theta = Conv2d(channels, 256, 1)
        self.phi = Conv2d(channels, 256, 1)

    def _descriptor(self, y: torch.Tensor, k: int = 1) -> torch.Tensor:
        """Descriptors (B, N, 256 k k) of a theta/phi output, its k x k
        unfold where k > 1: centered over the descriptor (PONO_C) or over
        positions, L2-normalized, f32 (correspondence.py:83-101)."""
        b, h, w, c = y.shape
        y = y.float()
        desc = (y.reshape(b, h * w, c) if k == 1
                else unfold_descriptors(y, k))
        desc = desc - desc.mean(dim=-1 if self.opt.PONO_C else 1,
                                keepdim=True)
        return desc / (safe_l2_norm(desc) + _EPS)

    def forward(self, ref_img: torch.Tensor, seg_map: torch.Tensor,
                ref_seg_map: torch.Tensor, temperature: float = 0.01,
                seg_label: Optional[torch.Tensor] = None,
                real_img: Optional[torch.Tensor] = None,
                WTA_scale_weight: float = 1.0, return_corr: bool = False,
                seg_noise: Optional[torch.Tensor] = None,
                ref_seg_noise: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """ref_img (B, H, W, 3); seg_map / ref_seg_map (B, H, W,
        semantic_nc) one-hot maps; seg_label, when given, the integer map
        whose one-hot IS seg_map: the seg adaptor's first conv then reads
        the labels (conv3x3_onehot) instead of the dense one-hot; real_img
        (B, H, W, 3), in train mode, the image the label map depicts;
        WTA_scale_weight and return_corr select the explicit-matrix path;
        seg_noise (seg_map's shape) and ref_seg_noise ((B, H/down, W/down,
        semantic_nc)) the standard-normal draws of --mask_noise and
        --noise_for_mask."""
        opt = self.opt
        train = self.training
        out: Dict[str, torch.Tensor] = {}
        b, ih, iw, _ = ref_img.shape
        fh, fw = ih // opt.down, iw // opt.down
        n = fh * fw

        seg_input = seg_map
        if opt.mask_noise and train:
            if seg_noise is None:
                raise ValueError("--mask_noise training needs its draw "
                                 "(seg_noise; pix2pix.draw_noise)")
            noise = seg_noise.to(seg_map.dtype) * 0.1
            seg_input = seg_map + torch.where(seg_map == 0,
                                              torch.zeros_like(noise), noise)
        adaptor_x = seg_input
        if seg_label is not None and seg_input is seg_map:
            adaptor_x = OneHotLabels(seg_label, opt.semantic_nc,
                                     seg_map.dtype)
        feat_seg = feature_normalize(self.adaptive_model_seg(adaptor_x,
                                                             seg_input))
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

        if opt.use_coordconv:
            feat_seg = add_coords(feat_seg)
            feat_img = add_coords(feat_img)

        seg_small = resize_nearest(seg_map, fh, fw)
        ref_seg_small = resize_nearest(ref_seg_map, fh, fw)
        if opt.maskmix:
            cont_features = self.layer(torch.cat([feat_seg, seg_small], -1))
            ref_mask = ref_seg_small
            if uses_ref_noise(opt, train):
                if ref_seg_noise is None and train:
                    raise ValueError(
                        "--noise_for_mask training needs its draw "
                        "(ref_seg_noise; pix2pix.draw_noise): refusing the "
                        "fixed draw of an eval call")
                if ref_seg_noise is None:
                    ref_seg_noise = _fixed_draw(ref_seg_small)
                ref_mask = (ref_seg_noise.to(ref_seg_small.device,
                                             ref_seg_small.dtype) * 0.01)
            ref_features = self.layer(torch.cat([feat_img, ref_mask], -1))
        else:
            cont_features = self.layer(feat_seg)
            ref_features = self.layer(feat_img)

        # descriptors stay f32: tau = 0.01 amplifies their error 100x
        y_theta = self.theta(cont_features).float()
        y_phi = self.phi(ref_features).float()

        # the values: the exemplar's d x d patches (--warp_patch) or its
        # avg-pooled colours, then the direct mask's one-hot columns
        if opt.warp_patch:
            ref_v = space_to_patches(ref_img, opt.down)
        else:
            ref_v = avg_pool(ref_img, opt.down).reshape(b, n, 3)
        need_direct_mask = (opt.warp_mask_losstype == "direct"
                            or opt.show_warpmask)
        values = [ref_v]
        if need_direct_mask:
            values.append(ref_seg_small.reshape(b, n, -1))
        v = torch.cat(values, -1)
        # the row warp attends from the label map's positions to the
        # exemplar's; the column (cycle) warp from the exemplar's back,
        # the same kernels with query and key swapped (correspondence.py:
        # 262-266, :321-325)
        sp = opt.mesh_model > 1
        if WTA_scale_weight != 1 or return_corr:
            if sp:
                warnings.warn(
                    "--mesh_model > 1 has no spatial-parallel form of the "
                    "explicit-matrix correlation (WTA_scale_weight != 1 / "
                    "return_corr): this path materializes the full HWxHW "
                    "matrix REPLICATED on every rank of the model group. "
                    "Results are correct but unsharded.", stacklevel=2)
            theta = self._descriptor(y_theta, opt.match_kernel)
            phi = self._descriptor(y_phi, opt.match_kernel)
            f = torch.matmul(theta, phi.transpose(1, 2))
            if WTA_scale_weight != 1:
                f = wta_scale(f, WTA_scale_weight)
            f = f / temperature
            if return_corr:
                out["corr"] = f
                return out
            f_div_c = torch.softmax(f, dim=-1)
            f_div_c_v = torch.softmax(f.transpose(1, 2), dim=-1)

            def row_attend(x):
                return torch.matmul(f_div_c, x.float())

            def col_attend(x):
                return torch.matmul(f_div_c_v, x.float())
        elif sp and (opt.match_kernel > 1 or opt.PONO_C):
            def attend_rows(q, k, x):
                return attend_sp(q, k, x, temperature,
                                 match_kernel=opt.match_kernel,
                                 pono_c=opt.PONO_C,
                                 use_pallas=opt.use_pallas,
                                 model=opt.mesh_model)

            def row_attend(x):
                return attend_rows(y_theta, y_phi, x)

            def col_attend(x):
                return attend_rows(y_phi, y_theta, x)
        elif opt.match_kernel == 1:
            if sp:
                warnings.warn(
                    "--mesh_model > 1 with match_kernel=1 requires --PONO_C "
                    "for the spatial-parallel correlation; falling back to "
                    "the dense-descriptor path REPLICATED over the model "
                    "axis. Results are correct but unsharded — add --PONO_C "
                    "(the flagship config) to shard this op.", stacklevel=2)
            theta = self._descriptor(y_theta)
            phi = self._descriptor(y_phi)
            kernels = opt.use_pallas and not (
                self.training and os.environ.get(MK1_TRAIN_ENV) != "1")
            mk1 = attend_corr if kernels else attend

            def row_attend(x):
                return mk1(theta, phi, x, temperature)

            def col_attend(x):
                return mk1(phi, theta, x, temperature)
        elif opt.use_pallas and opt.match_kernel == 3:
            def row_attend(x):
                return attend_shift9(y_theta, y_phi, x, temperature,
                                     opt.PONO_C)

            def col_attend(x):
                return attend_shift9(y_phi, y_theta, x, temperature,
                                     opt.PONO_C)
        else:
            def row_attend(x):
                return attend_unfold(y_theta, y_phi, x, temperature,
                                     opt.match_kernel, opt.PONO_C)

            def col_attend(x):
                return attend_unfold(y_phi, y_theta, x, temperature,
                                     opt.match_kernel, opt.PONO_C)
        row_out = row_attend(v)
        dv = ref_v.shape[-1]
        show_bi = not train and opt.show_corr
        if opt.warp_patch:
            y = patches_to_space(row_out[..., :dv], opt.down, ih, iw)
            out["warp_out"] = y
            if show_bi:
                out["warp_out_bi"] = y
        else:
            y = row_out[..., :dv].reshape(b, fh, fw, 3)
            out["warp_out"] = (upsample_bilinear(y, opt.down)
                               if opt.warp_bilinear
                               else upsample_nearest(y, opt.down))
            if show_bi:
                out["warp_out_bi"] = upsample_bilinear(y, opt.down)
        if need_direct_mask:
            out["warp_mask"] = row_out[..., dv:].reshape(b, fh, fw, -1)
        elif opt.warp_mask_losstype == "cycle":
            # the label map to the exemplar and back (correspondence.py:
            # 360-365)
            to_ref = col_attend(seg_small.reshape(b, n, -1))
            out["warp_mask"] = row_attend(to_ref).reshape(b, fh, fw, -1)
        if opt.warp_cycle_w > 0:
            # the warp carried back to the exemplar: the patches of the
            # folded warp, or the feature-grid colours (correspondence.py:
            # 366-382)
            if opt.warp_patch:
                back = col_attend(space_to_patches(y, opt.down))
                out["warp_cycle"] = patches_to_space(back, opt.down, ih, iw)
            else:
                out["warp_cycle"] = col_attend(y.reshape(b, n, 3)).reshape(
                    b, fh, fw, 3)
                if opt.two_cycle and real_img is not None:
                    i2r = col_attend(avg_pool(real_img, opt.down).reshape(
                        b, n, 3))
                    out["warp_i2r"] = i2r.reshape(b, fh, fw, 3)
                    out["warp_i2r2i"] = row_attend(i2r).reshape(b, fh, fw,
                                                                3)
        return out
