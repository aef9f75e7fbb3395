"""Frozen VGG19 feature extractor for the perceptual and contextual losses.

Counterpart of cocosnet_tpu/nn/vgg.py (VGG19_feature_color_torchversion of
the reference, correspondence.py:79-146) with the caffe-style preprocessing
of util/util.py:45-54: RGB (from [-1, 1] to [0, 1] first under
--vgg_normal_correct) -> BGR, mean-subtract, x255. The convs keep the
reference's names (conv1_1 ... conv5_4); their weights take no gradient.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as tnn

from cocosnet_tpu_torch.nn.layers import Conv2d
from cocosnet_tpu_torch.ops.image import max_pool

# BGR channel means of the caffe-trained VGG (util/util.py:52)
_VGG_MEAN_BGR = (0.40760392, 0.45795686, 0.48501961)

_LAYERS = [
    ("conv1_1", 64), ("conv1_2", 64),
    ("conv2_1", 128), ("conv2_2", 128),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512),
]


def vgg_preprocess(x: torch.Tensor,
                   vgg_normal_correct: bool = False) -> torch.Tensor:
    """util/util.py:45-54 on an NHWC RGB image."""
    if vgg_normal_correct:
        x = (x + 1.0) / 2.0
    bgr = x.flip(-1)
    mean = torch.tensor(_VGG_MEAN_BGR, dtype=x.dtype, device=x.device)
    return (bgr - mean) * 255.0


class VGG19Features(tnn.Module):
    """Returns the activations named in out_keys (r11 .. r54, p1 .. p5),
    f32, for an NHWC image."""

    def __init__(self, vgg_normal_correct: bool = False):
        super().__init__()
        self.vgg_normal_correct = vgg_normal_correct
        cin = 3
        for name, width in _LAYERS:
            self.add_module(name, Conv2d(cin, width, 3, padding=1))
            cin = width
        for p in self.parameters():
            p.requires_grad_(False)

    def forward(self, x: torch.Tensor,
                out_keys: Sequence[str]) -> List[torch.Tensor]:
        h = vgg_preprocess(x, self.vgg_normal_correct)
        out: Dict[str, torch.Tensor] = {}
        for name, _ in _LAYERS:
            block, idx = name[4], name[6]
            h = torch.relu(self._modules[name](h))
            out[f"r{block}{idx}"] = h
            if idx == ("2" if block in "12" else "4"):
                h = max_pool(h, 2)
                out[f"p{block}"] = h
        # the taps feed f32 loss math whatever the activation policy
        return [out[k].float() for k in out_keys]
