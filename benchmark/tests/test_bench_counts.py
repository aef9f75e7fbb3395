"""The benchmark's copies of the counts, against worked shapes."""

from __future__ import annotations

import math
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import counts  # noqa: E402
from benchmark import modes  # noqa: E402
from benchmark import trace as T  # noqa: E402


def test_conv3x3_flops_of_the_residual_shape():
    # 512 -> 512 at 64 x 64, batch 6: 115.97 GFLOP, 0.117 ms at 989 TFLOP/s
    ops = counts.conv3x3_flops(6, 64, 64, 512, 512)
    assert ops == 2 * 6 * 64 * 64 * 9 * 512 * 512
    assert math.isclose(ops / 1e9, 115.97, rel_tol=1e-4)
    nbytes = 2 * (6 * 64 * 64 * 512 * 2) + 9 * 512 * 512 * 2
    seconds, what = counts.bound_s(ops, nbytes)
    assert what == "operations"
    assert math.isclose(seconds * 1e3, 0.11726, rel_tol=1e-3)


@pytest.mark.parametrize("b, d, want_gflop", [(6, 154, 185.62),
                                              (4, 48, 109.52)])
def test_shift9_fwd_flops_at_the_feature_grid(b, d, want_gflop):
    # 64 x 64 queries and keys, C 256: 2 B N^2 (3C + D)
    ops = counts.shift9_fwd_flops(b, 4096, 4096, 256, d)
    assert ops == 2 * b * 4096 * 4096 * (3 * 256 + d)
    assert math.isclose(ops / 1e9, want_gflop, rel_tol=1e-4)


def test_shift9_bwd_flops():
    ops = counts.shift9_bwd_flops(8, 4096, 4096, 256, 154)
    assert ops == 2 * 8 * 4096 * 4096 * (9 * 256 + 2 * 154)
    assert math.isclose(ops / 1e12, 0.70115, rel_tol=1e-4)


def test_bound_by_bytes():
    seconds, what = counts.bound_s(1e9, 3.35e10)
    assert what == "bytes" and math.isclose(seconds, 0.01)


@pytest.mark.parametrize("name, fam", [
    ("void conv3x3::conv3x3_bf16_kernel<2>(...)", "conv3x3.cu"),
    ("k_major_weights_kernel", "conv operand copies"),
    ("void shift9_fwd::shift9_fwd_kernel<160>(...)", "shift9_fwd.cu"),
    ("void tc::gemm_kernel<shift9_bwd::Src, true, 4>(...)", "shift9_bwd.cu"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "library conv (cuDNN)"),
    ("void at::native::(anonymous)::multi_tensor_apply_kernel<Adam>",
     "optimizer (Adam, EMA)"),
    ("void at::native::vectorized_elementwise_kernel<4, add>",
     "elementwise / other"),
])
def test_kernel_families(name, fam):
    assert counts.family(name) == fam


def test_model_flops_of_a_conv_on_meta():
    with torch.device("meta"):
        x = torch.zeros(2, 8, 16, 16)
        w = torch.zeros(4, 8, 3, 3)
    ops = counts.model_flops(
        lambda: torch.nn.functional.conv2d(x, w, padding=1))
    assert ops == 2 * 2 * 16 * 16 * 9 * 8 * 4


def test_flagship_forward_flops_on_meta():
    """The plain reference's B6 flagship forward: about 6 TFLOP."""
    import json
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "configs", "ade20k.json")) as f:
        model = json.load(f)["model"]
    from benchmark.reference import model as R
    with torch.device("meta"):
        nets = R.Nets(model, False)
    ops = counts.model_flops(
        lambda: R.inference(nets, modes.meta_batch(model, 6)))
    assert 5e12 < ops < 7e12


def test_trace_busy_is_the_union_of_records():
    rec = T.Trace(units=1, window_s=1.0,
                  kernels=[("a", 0.0, 10.0), ("b", 5.0, 20.0),
                           ("c", 30.0, 40.0)],
                  host=[("serve.wait", 19.0, 31.0)])
    assert math.isclose(rec.busy_s, 30e-6)
    assert rec.breakdown()["idle_gaps"] == [["serve.wait", 10e-6]]
