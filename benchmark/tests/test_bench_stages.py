"""The readers of the port's own tracing (benchmark/stages.py and the
metrics that call it) on synthetic trace records and span lists."""

from __future__ import annotations

import math
import os
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import counts, stages  # noqa: E402
from benchmark import trace as T  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402
from cocosnet_tpu_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _mark(stage, at):
    return (f"stage_mark_{stage}()", at, at + 1.0)


def _forwards(units, lose=None):
    """`units` forwards 100 us apart: a copy in, the marks with an op after
    each (prep 4 us, corr 30, gen 20, then the copy out), as a serve
    graph's replays record them; `lose`: (unit, stage) whose mark the
    profiler lost."""
    kernels = []
    for u in range(units):
        t = 100.0 * u
        kernels.append(("Memcpy HtoD (Pageable -> Device)", t, t + 5))
        for stage, at, op in (("prep", 6, 4), ("corr", 11, 30),
                              ("gen", 42, 20), ("end", 63, 5)):
            if (u, stage) != lose:
                kernels.append(_mark(stage, t + at))
            kernels.append(("elementwise_kernel", t + at + 1,
                            t + at + 1 + op))
    return kernels


def _run(kernels, units, host=()):
    return SimpleNamespace(trace=T.Trace(units=units, window_s=1.0,
                                         kernels=kernels, host=list(host)))


def test_a_stage_is_the_union_from_its_mark_to_the_next():
    run = _run(_forwards(3), 3)
    # corr: its mark (1 us) and its op (30 us), gen: 1 + 20
    assert math.isclose(stages.stage_ms(run, "corr"), 0.031)
    assert math.isclose(stages.stage_ms(run, "gen"), 0.021)
    assert math.isclose(stages.stage_ms(run, "prep", "corr", "gen"), 0.057)
    parts = stages.partition(run.trace.kernels)
    # the copies before a unit's first mark and after its end belong to no
    # stage the readers read; with them the stages add up to the busy time
    assert math.isclose(sum(parts.values()), run.trace.busy_s)
    assert math.isclose(parts[None], 5e-6)
    assert math.isclose(parts["end"], 3 * 6e-6 + 2 * 5e-6)


def test_overlapping_operations_count_once():
    kernels = [_mark("corr", 0.0), ("a", 1.0, 11.0), ("b", 5.0, 15.0),
               _mark("gen", 15.0), ("c", 14.0, 14.5), ("d", 16.0, 20.0)]
    parts = stages.partition(kernels)
    assert math.isclose(parts["corr"], 15e-6)
    assert math.isclose(parts["gen"], 5e-6)


@pytest.mark.parametrize("lose", [(0, "corr"), (2, "gen"), (1, "end")])
def test_a_lost_mark_reads_none(lose):
    run = _run(_forwards(3, lose=lose), 3)
    assert stages.stage_ms(run, "corr") is None
    assert stages.stage_ms(run, "gen") is None


def test_marks_out_of_order_or_twice_read_none():
    kernels = _forwards(2)
    kernels.append(_mark("corr", 150.0))          # a second corr in unit 1
    assert stages.stage_ms(_run(kernels, 2), "corr") is None
    assert stages.stage_ms(_run(_forwards(2), 3), "corr") is None
    assert stages.stage_ms(_run(_forwards(2), 2), "d_step") is None


def test_the_parent_without_spans_reads_none(monkeypatch):
    run = _run(_forwards(2), 2)
    assert stages.stage_ms(run, "corr") is not None
    monkeypatch.delattr(profiling, "spans")
    assert stages.stage_ms(run, "corr") is None
    assert stages.span_ms(run, "serve.copy_in") is None


def _requests(units, t0=1000.0):
    """Host records and spans of `units` requests 100 us apart (a copy in
    of 10 us with 4 us of device copy inside, a launch of 8 us with the
    graph's first 3 us inside), after a padding synchronize."""
    host = [("cudaDeviceSynchronize", t0 - 50, t0 - 10)]
    kernels, spans = [], []
    for u in range(units):
        t = t0 + 100.0 * u
        host.append(("request", t, t + 90))
        spans.append(profiling.Span("serve.copy_in", int(t * 1e3),
                                    int((t + 10) * 1e3), u + 1, None))
        spans.append(profiling.Span("serve.launch", int((t + 10) * 1e3),
                                    int((t + 18) * 1e3), u + 1, None))
        kernels.append(("Memcpy HtoD", t + 4, t + 8))
        kernels.append(("graph_kernel", t + 15, t + 60))
    return host, kernels, spans


def test_request_spans_outside_the_segment_are_left_out(monkeypatch):
    host, kernels, spans = _requests(3)
    # the window's requests, before the traced segment
    _, _, before = _requests(4, t0=0.0)
    monkeypatch.setattr(profiling, "spans", lambda: before + spans)
    run = _run(kernels, 3, host)
    assert math.isclose(stages.span_ms(run, "serve.copy_in"), 0.006)
    assert math.isclose(stages.span_ms(run, "serve.launch"), 0.005)
    # a span the segment lacks reads None, not a median of the others
    monkeypatch.setattr(profiling, "spans", lambda: before + spans[1:])
    assert stages.span_ms(run, "serve.copy_in") is None
    assert stages.span_ms(run, "serve.launch") is not None


@pytest.mark.parametrize("stage", profiling.STAGES)
def test_a_mark_counts_as_elementwise(stage):
    for name in (f"stage_mark_{stage}()", f"stage_mark_{stage}"):
        assert counts.family(name) == counts.ELEMENTWISE
        assert stages.stage_of(name) == stage
    assert stages.stage_of("void at::native::elementwise_kernel") is None


def test_the_metrics_read_the_stages(monkeypatch):
    bench = Manifest(ROOT)
    run = _run(_forwards(2), 2)
    assert math.isclose(bench.reader("corr_ms.infer").read(run), 0.031)
    assert math.isclose(bench.reader("gen_ms.infer").read(run), 0.021)
    host, kernels, spans = _requests(2)
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    run = _run(kernels, 2, host)
    assert math.isclose(bench.reader("copy_in_ms.request").read(run), 0.006)
    assert math.isclose(bench.reader("launch_ms.request").read(run), 0.005)
    train = [m["name"] for m in bench.data["per_layer"]
             if m["source"] == "program_span"
             and m["moves"] == "train_images_per_s"]
    assert len(train) == 6
    step = []
    for i, stage in enumerate(profiling.STAGES):
        step += [_mark(stage, 10.0 * i), ("op", 10.0 * i + 1, 10.0 * i + 3)]
    run = _run(step, 1)
    got = {m: bench.reader(m).read(run) for m in train}
    assert math.isclose(got["g_forward_ms.train"], 0.009)
    assert all(math.isclose(got[m], 0.003) for m in train
               if m != "g_forward_ms.train")
