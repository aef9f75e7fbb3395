"""The plain reference against the port, on the CPU at small sizes and in
float32 (the port's plain versions), on the benchmark's own weights and
batches: the served image of both configurations' networks, and a train
step's losses and gradients."""

from __future__ import annotations

import os
import statistics
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)

import bench_tiny  # noqa: E402
from benchmark import inputs, modes, program  # noqa: E402
from benchmark.reference import model as R  # noqa: E402
from benchmark.reference import train as RT  # noqa: E402

CPU = torch.device("cpu")
DEEPFASHION_FLAGS = ["--dataset_mode", "deepfashion", "--warp_bilinear",
                     "--no_flip", "--warp_patch", "--video_like",
                     "--adaptor_kernel", "4", "--use_attention", "--PONO",
                     "--PONO_C", "--ngf", "8", "--ndf", "8", "--crop_size",
                     "64", "--load_size", "64"]
DEEPFASHION = dict(bench_tiny.MODEL, label_mode="dense", semantic_nc=20,
                   maskmix=False, warp_mask_losstype="none", adaptor_kernel=4,
                   warp_patch=True, warp_bilinear=True,
                   vgg_normal_correct=False, use_ema=False, weight_mask=0.0)
CONFIGS = {
    "ade20k": ({"flags": bench_tiny.FLAGS, "model": bench_tiny.MODEL},
               {"blobs": 4, "grid": 4, "self_ref": 0.5}),
    "deepfashion": ({"flags": DEEPFASHION_FLAGS, "model": DEEPFASHION},
                    {"channels": 20, "grid": 4}),
}


def f32(config):
    return {"flags": config["flags"] + ["--compute_dtype", "f32"],
            "model": dict(config["model"], compute_dtype="f32")}


@pytest.fixture(autouse=True)
def _numerics():
    from cocosnet_tpu_torch.nn import layers
    torch.manual_seed(0)
    yield
    layers.set_compute_dtype(None)


def _setup(name, train, b, seed):
    config, spec = CONFIGS[name]
    config = f32(config)
    opt = program.options(config, train, b)
    program.set_numerics(opt)
    model = config["model"]
    weights = inputs.make_weights(modes.reference_shapes(model, train), seed,
                                  CPU)
    traffic = {"pool": 2, "batch": b, "inputs": spec}
    batches = inputs.make_batches(traffic, model, seed, CPU, train=train)
    return opt, model, weights, batches


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_served_image_matches_the_port(name):
    from cocosnet_tpu_torch import pix2pix as P
    opt, model, weights, batches = _setup(name, False, 2, 7)
    nets = program.build_nets(opt, CPU, weights)
    ref = modes.reference_nets(model, False, weights, CPU)
    with torch.no_grad():
        for batch in batches:
            got = P.inference(nets, P.preprocess_input(opt, batch, CPU))
            want = R.inference(ref, batch)
            err = float((got["fake_image"] - want).abs().max())
            assert err < 2e-4, err
            assert float(want.std()) > 0.05


def test_train_step_matches_the_port():
    opt, model, weights, batches = _setup("ade20k", True, 2, 9)
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
        assert abs(got[k] - v) <= 1e-4 * max(abs(v), 1.0), (k, got[k], v)
    want_grads = {k: float(g.norm()) for k, g in grads.items()}
    assert set(got_grads) == set(want_grads)
    med = statistics.median(want_grads.values())
    worst = max(abs(got_grads[k] - w) / max(w, med)
                for k, w in want_grads.items())
    assert worst < 5e-3, worst
