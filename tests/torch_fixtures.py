"""Helpers of the port's tests that import no JAX, so that the card tests
(tests/test_torch_cuda.py, run with --noconftest where JAX is absent) can
use them too."""

import torch

from cocosnet_tpu_torch.nn.blocks import Attention
from cocosnet_tpu_torch.nn.layers import Conv2d, PReLU


def condition(module, seed):
    """Weights at unit signal scale: conv kernels at 1/sqrt(fan_in),
    biases at 0.1, PReLU slopes 0.2, attention gates 0.5, and the spectral
    u/v the leading singular vectors, so sigma is the spectral norm (the
    init leaves sigma near 0 and the output near 0)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv2d):
                w = m.weight if m.weight_norm is None else m.weight_orig
                w.copy_(torch.randn(w.shape, generator=g)
                        * w[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
                if m.weight_norm == "spectral":
                    u, _, vh = torch.linalg.svd(
                        w.reshape(w.shape[0], -1).double(),
                        full_matrices=False)
                    m.weight_u.copy_(u[:, 0])
                    m.weight_v.copy_(vh[0])
            elif isinstance(m, PReLU):
                m.weight.fill_(0.2)
            elif isinstance(m, Attention):
                m.gamma.fill_(0.5)
