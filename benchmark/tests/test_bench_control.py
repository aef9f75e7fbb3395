"""The control of each comparison comes out not correct: the plain
reference put in the program's place with every convolution's operands
in fp8, one step below the configuration's bf16. On the CPU at the tiny
configuration against its cells' limits; on the card (marked cuda) at the
cells' own sizes against theirs."""

from __future__ import annotations

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import bench_tiny  # noqa: E402
from benchmark import calibrate, manifest  # noqa: E402
from benchmark.compare import fp8_round  # noqa: E402


def _fails(readings, limits) -> bool:
    return any(readings[k] > v for k, v in limits.items())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _cell(root, name):
    bench = manifest.Manifest(root)
    entry = bench.cell(name)
    return bench.config(entry["config"])["model"], bench.traffic(name, entry)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return bench_tiny.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("seed", [1, 2])
def test_serve_control_fails_on_the_cpu(tiny_root, seed):
    model, traffic = _cell(tiny_root, "tiny.infer-b2")
    readings = calibrate.serve_control(model, traffic, seed,
                                       torch.device("cpu"))
    assert _fails(readings, traffic["limits"]), readings


def test_train_control_fails_on_the_cpu(tiny_root):
    model, traffic = _cell(tiny_root, "tiny.train-b2")
    readings = calibrate.train_readings(model, traffic, 1,
                                        torch.device("cpu"),
                                        rounding=fp8_round)
    assert _fails(readings, traffic["limits"]), readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ade20k.infer-b6", "deepfashion.infer-b4",
                                  "ade20k.request-b1"])
def test_serve_control_fails_on_the_card(card, cell):
    model, traffic = _cell(ROOT, cell)
    for seed in (1, 2, 3):
        readings = calibrate.serve_control(model, traffic, seed, card)
        assert _fails(readings, traffic["limits"]), (seed, readings)


@pytest.mark.cuda
def test_train_control_fails_on_the_card(card):
    model, traffic = _cell(ROOT, "ade20k.train-b8")
    for seed in (1, 2, 3):
        readings = calibrate.train_readings(model, traffic, seed, card,
                                            rounding=fp8_round)
        assert _fails(readings, traffic["limits"]), (seed, readings)
