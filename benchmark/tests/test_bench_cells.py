"""Whole runs of the harness on the CPU (the port's plain versions), on
cells of a tiny configuration that a tree of their own adds by files
alone: a sound run comes out correct, and a run whose timed path is
broken underneath comes out not correct, once for each fault its cell can
have."""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import bench_tiny  # noqa: E402
from benchmark import calibrate, program, run  # noqa: E402

SEED = 3000000007          # more than 32 signed bits hold


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_tiny.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(autouse=True)
def _numerics():
    yield
    from cocosnet_tpu_torch.nn import layers
    layers.set_compute_dtype(None)


def _argv(root, cell, trace=0):
    return ["--workload", cell, "--seed", str(SEED), "--seconds", "1",
            "--trace", str(trace), "--device", "cpu", "--root", root]


def _run(root, cell):
    """(exit code, the result line or None, standard error) of run.main."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(_argv(root, cell))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.mark.parametrize("cell", sorted(bench_tiny.CELLS))
def test_a_cell_added_by_files_runs_correct(root, cell):
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         *_argv(root, cell)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)
    assert result["correct"] is True, result["compared"]
    kind = cell.split(".")[1].split("-")[0]
    assert set(result["metrics"]) == {"setup_s", bench_tiny.METRIC[kind]}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    tail = proc.stderr.strip().splitlines()[-len(result["compared"]):]
    assert all(line.startswith("compared ") for line in tail)


def test_no_card_no_result(root):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "tiny.infer-b2", "--seed", "1", "--seconds", "1",
         "--trace", "0", "--root", root], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()


def _altered_answer(real_to_host):
    def to_host(out):
        host, done = real_to_host(out)
        host = host.clone()
        host[0] = 255 - host[0]
        return host, done
    return to_host


def _half_batch_served(real_serve_step):
    def serve_step(nets, batch):
        step = real_serve_step(nets, batch)

        def half(x):
            out = step(x).clone()
            out[out.shape[0] // 2:] = 0
            return out
        return half
    return serve_step


def _unchanged_state(real_trainer, which=lambda name: True):
    def trainer(opt, nets):
        state, multi, lr = real_trainer(opt, nets)
        leaves = {k: v for k, v in program.trained_leaves(state, nets).items()
                  if which(k)}

        def frozen(state, batches, lr):
            kept = {k: v.detach().clone() for k, v in leaves.items()}
            out = multi(state, batches, lr)
            with torch.no_grad():
                for k, v in leaves.items():
                    v.copy_(kept[k])
            return out
        return state, frozen, lr
    return trainer


def _half_batch_trained(real_trainer):
    def trainer(opt, nets):
        state, multi, lr = real_trainer(opt, nets)

        def half(state, batches, lr):
            return multi(state, [{k: v[: v.shape[0] // 2]
                                  for k, v in b.items()} for b in batches],
                         lr)
        return state, half, lr
    return trainer


def _unchanged_ema(real_trainer):
    return _unchanged_state(real_trainer, lambda k: k.startswith("ema."))


FAULTS = {
    "answer altered": ("tiny.infer-b2", "to_host", _altered_answer),
    "half the batch left out (serve)": ("tiny.infer-b2", "serve_step",
                                        _half_batch_served),
    "answer altered (request)": ("tiny.request-b1", "to_host",
                                 _altered_answer),
    "state left unchanged": ("tiny.train-b2", "trainer", _unchanged_state),
    "half the batch left out (train)": ("tiny.train-b2", "trainer",
                                        _half_batch_trained),
    "EMA left unchanged (train)": ("tiny.train-b2", "trainer",
                                   _unchanged_ema),
    "half the batch left out in the replayed steps (train)": (
        "tiny.train-b2", "trainer", calibrate._replay_half),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(root, fault, monkeypatch):
    cell, name, breaker = FAULTS[fault]
    monkeypatch.setattr(program, name, breaker(getattr(program, name)))
    rc, result, err = _run(root, cell)
    assert rc == 0 and result is not None, err[-3000:]
    assert result["correct"] is False, result["compared"]
    assert "FAILED" in err
