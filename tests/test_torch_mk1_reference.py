"""match_kernel 1 (the paper's Eq. 2: the cosine of single positions'
channel-centred features) in the port against the benchmark's plain
float32 reference (benchmark/reference/), on the CPU at the size of the
benchmark's own CPU tests (64 px, ngf 8, 12 classes one-hot, maskmix,
the direct mask loss, PONO_C), on the weights and batches that
benchmark/inputs.py draws from a seed: the served image, one train
step's losses and gradients, and the two correlations' references kept
apart, so that a configuration that silently ran match_kernel 3 fails."""

from __future__ import annotations

import os
import statistics
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "tests"))

import bench_tiny  # noqa: E402
from benchmark import inputs, modes, program  # noqa: E402
from benchmark.reference import model as R  # noqa: E402
from benchmark.reference import train as RT  # noqa: E402
from cocosnet_tpu_torch import pix2pix as P  # noqa: E402
from cocosnet_tpu_torch.nn import layers  # noqa: E402
from cocosnet_tpu_torch.ops import corr  # noqa: E402
from test_torch_threads import torch_threads  # noqa: E402,F401

CPU = torch.device("cpu")
SPEC = {"blobs": 4, "grid": 4, "self_ref": 0.5}
# the served image and the losses within the tolerances of
# benchmark/tests/test_bench_reference.py: f32 reordering between NHWC
# and NCHW, fused and plain ops
IMAGE_TOL = 2e-4
LOSS_TOL = 1e-4
GRAD_TOL = 5e-3


def config(match_kernel: int) -> dict:
    """bench_tiny's configuration at match_kernel k, in float32."""
    return {"flags": bench_tiny.FLAGS + ["--match_kernel", str(match_kernel),
                                         "--compute_dtype", "f32"],
            "model": dict(bench_tiny.MODEL, match_kernel=match_kernel,
                          compute_dtype="f32")}


@pytest.fixture(autouse=True)
def _numerics():
    torch.manual_seed(0)
    yield
    layers.set_compute_dtype(None)


def _setup(train: bool, b: int, seed: int, match_kernel: int = 1):
    cfg = config(match_kernel)
    opt = program.options(cfg, train, b)
    program.set_numerics(opt)
    model = cfg["model"]
    weights = inputs.make_weights(modes.reference_shapes(model, train), seed,
                                  CPU)
    traffic = {"pool": 2, "batch": b, "inputs": SPEC}
    batches = inputs.make_batches(traffic, model, seed, CPU, train=train)
    return opt, model, weights, batches


def test_the_options_are_match_kernel_1():
    opt = program.options(config(1), False, 2)
    assert opt.match_kernel == 1 and opt.PONO_C


@pytest.mark.parametrize("seed", [7, 3000000019])
def test_served_image_matches_the_reference(seed):
    opt, model, weights, batches = _setup(False, 2, seed)
    nets = program.build_nets(opt, CPU, weights)
    ref = modes.reference_nets(model, False, weights, CPU)
    calls = corr.attend_corr.plain_calls
    with torch.no_grad():
        for batch in batches:
            got = P.inference(nets, P.preprocess_input(opt, batch, CPU))
            want = R.inference(ref, batch)
            err = float((got["fake_image"] - want).abs().max())
            assert err < IMAGE_TOL, err
            assert float(want.std()) > 0.05
    # inference takes the kernels' route (attend_corr), here its plain
    # version: one call a forward
    assert corr.attend_corr.plain_calls - calls == len(batches)


def test_train_step_matches_the_reference():
    opt, model, weights, batches = _setup(True, 2, 9)
    nets = program.build_nets(opt, CPU, weights)
    state, multi, lr = program.trainer(opt, nets)
    losses, _ = multi(state, batches[:1], lr)
    got = {k: float(v[0]) for k, v in losses.items()}
    got_grads = {k: float(m.norm()) for k, m in
                 program.first_moments(state, nets).items()}
    trainer = RT.Trainer(modes.reference_nets(model, True, weights, CPU))
    want, grads = trainer.step(batches[0])
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= LOSS_TOL * max(abs(v), 1.0), (k, got[k], v)
    want_grads = {k: float(g.norm()) for k, g in grads.items()}
    assert set(got_grads) == set(want_grads)
    med = statistics.median(want_grads.values())
    worst = max(abs(got_grads[k] - w) / max(w, med)
                for k, w in want_grads.items())
    assert worst < GRAD_TOL, worst


def test_the_two_correlations_give_images_far_apart():
    """The same weights and batches through the reference at match_kernel
    1 and 3: a port that ran the 3 x 3 unfold under the mk1
    configuration would miss the served tolerance by orders of
    magnitude."""
    _, model, weights, batches = _setup(False, 2, 7)
    images = {}
    with torch.no_grad():
        for k in (1, 3):
            cfg = dict(model, match_kernel=k)
            ref = modes.reference_nets(cfg, False, weights, CPU)
            images[k] = R.inference(ref, batches[0])
    gap = float((images[1] - images[3]).abs().max())
    assert gap > 100 * IMAGE_TOL, gap
