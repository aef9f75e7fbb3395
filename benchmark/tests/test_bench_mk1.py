"""The ade20k-mk1 configuration and its cell: the configuration's flags
against what the reference assumes, its traffic file, the reader of
corr_fwd_roofline.infer on made-up traces, and its count against the
port's own."""

from __future__ import annotations

import math
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import calibrate, corr_counts, counts, manifest  # noqa: E402
from benchmark import program  # noqa: E402
from benchmark import trace as T  # noqa: E402
from benchmark.run import Run  # noqa: E402

CELL = "ade20k-mk1.infer-b6"
BENCH = manifest.Manifest(ROOT)
ENTRY = BENCH.cell(CELL)
CONFIG = BENCH.config(ENTRY["config"])
TRAFFIC = BENCH.traffic(CELL, ENTRY)
KERNEL = "void corr_fwd_kernel<2>(float const*, float const*, ...)"


@pytest.mark.parametrize("train", [False, True])
def test_the_flags_hold_to_the_reference(train):
    opt = program.options(CONFIG, train, TRAFFIC["batch"])
    assert opt.match_kernel == 1 and opt.PONO_C
    assert CONFIG["model"]["match_kernel"] == 1


def test_it_is_the_flagship_but_for_the_correlation():
    flagship = BENCH.config("ade20k")
    assert CONFIG["model"] == dict(flagship["model"], match_kernel=1)
    assert CONFIG["reduced"] == []


def test_the_traffic_file_names_its_cell():
    assert (TRAFFIC["config"], TRAFFIC["traffic"]) == ("ade20k-mk1",
                                                       "infer-b6")
    assert ENTRY["chips"] == 1
    same = BENCH.traffic("ade20k.infer-b6", BENCH.cell("ade20k.infer-b6"))
    assert {k: v for k, v in TRAFFIC.items() if k != "config"} == {
        k: v for k, v in same.items() if k != "config"}


def test_the_cell_reads_the_correlation_and_not_shift9():
    names = {m["name"] for m in BENCH.per_layer(CELL)}
    assert "corr_fwd_roofline.infer" in names
    assert "shift9_fwd_roofline.infer" not in names
    assert {"corr_ms.infer", "gen_ms.infer", "mfu.infer",
            "idle_share.infer"} <= names


def _run(kernels, units=2):
    run = Run(ENTRY, CONFIG, TRAFFIC, 1, None)
    run.trace = T.Trace(units=units, window_s=1.0, kernels=kernels)
    return run


def test_the_reader_is_none_without_its_kernel():
    reader = BENCH.reader("corr_fwd_roofline.infer")
    assert reader.read(Run(ENTRY, CONFIG, TRAFFIC, 1, None)) is None
    assert reader.read(_run([])) is None
    assert reader.read(_run([("void shift9_fwd::shift9_fwd_kernel<160>",
                              0.0, 5000.0)])) is None


def test_the_reader_divides_the_bound_by_the_time_a_call():
    # two calls of 2.8 ms and the family's other time counted once
    kernels = [(KERNEL, 0.0, 2800.0), (KERNEL, 5000.0, 7800.0),
               ("void shift9_fwd::shift9_fwd_kernel<160>", 8000.0, 9000.0)]
    got = BENCH.reader("corr_fwd_roofline.infer").read(_run(kernels))
    ops, nbytes = corr_counts.call(CONFIG["model"], TRAFFIC["batch"])
    bound, what = counts.bound_s(ops, nbytes)
    assert what == "operations"
    assert math.isclose(got, 100.0 * bound / 2.8e-3, rel_tol=1e-9)
    assert math.isclose(got, 2.98, rel_tol=1e-2)
    assert counts.family(KERNEL) == corr_counts.FAMILY


def test_the_count_is_the_ports():
    from cocosnet_tpu_torch.utils import profiling
    b, n, m, c, d = corr_counts.shapes(CONFIG["model"], TRAFFIC["batch"])
    assert (b, n, m, c, d) == (6, 4096, 4096, 256, 154)
    ops, nbytes = corr_counts.call(CONFIG["model"], TRAFFIC["batch"])
    assert ops == profiling.corr_fwd_flops(b, n, m, c, d)
    assert math.isclose(ops / 1e9, 82.544, rel_tol=1e-4)
    assert nbytes == 4 * (2 * b * n * c + 2 * b * n * d + b * n)


@pytest.mark.cuda
def test_the_control_fails_the_limit_on_the_card():
    """The reference with every convolution in fp8, one step below the
    configuration's bf16, at the cell's own sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in (1, 2, 3):
        readings = calibrate.serve_control(CONFIG["model"], TRAFFIC, seed,
                                           torch.device("cuda"))
        assert readings["image_mad"] > TRAFFIC["limits"]["image_mad"], (
            seed, readings)
