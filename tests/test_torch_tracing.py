"""The port's own tracing on the CPU (cocosnet_tpu_torch/utils/profiling.py):

- host spans: nesting, the parent's name, the id a span shares with its
  parent, the ring's bound; their clock is that of torch.profiler's
  records (a span around a matmul encloses the op's record, within 50 us
  at each end); maybe_trace's Chrome trace holds the block's spans beside
  the profiler's ops;
- stage marks: the stages of csrc/stage_mark.cu are profiling.STAGES in
  order; off the card a mark launches nothing; with the marks recorded by
  name, the eager serve forward marks prep, corr, gen, end and one eager
  fused train step every stage, in order (tiny nets: 64 px, ngf 8, f32).

The marks' records in a device trace, captured into the serve graph and
the chunk graph, are tests/test_torch_cuda.py's."""

import json
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.ops import _build
from cocosnet_tpu_torch.tools import serve as SV
from cocosnet_tpu_torch.train import state as TS
from cocosnet_tpu_torch.train import steps as TST
from cocosnet_tpu_torch.utils import profiling as PR
from test_torch_threads import torch_threads  # noqa: F401

MODEL = dict(dataset_mode="ade20k", label_nc=5, contain_dontcare_label=True,
             crop_size=64, load_size=64, ngf=8, ndf=8, PONO=True,
             PONO_C=True, use_attention=True, maskmix=True,
             warp_mask_losstype="direct", compute_dtype="f32")


def _named(name):
    return [s for s in PR.spans() if s.name == name]


def test_spans_nest_and_share_their_parents_id():
    with PR.span("test.outer", 7):
        with PR.span("test.inner"):
            pass
        with PR.span("test.own", 9):
            pass
    with PR.span("test.alone"):
        pass
    outer, = _named("test.outer")[-1:]
    inner, = _named("test.inner")[-1:]
    own, = _named("test.own")[-1:]
    alone, = _named("test.alone")[-1:]
    assert (outer.parent, outer.trace_id) == (None, 7)
    assert (inner.parent, inner.trace_id) == ("test.outer", 7)
    assert (own.parent, own.trace_id) == ("test.outer", 9)
    assert (alone.parent, alone.trace_id) == (None, None)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= own.start_ns <= own.end_ns <= outer.end_ns
    # recorded as each closes: the inner spans before the outer one
    order = [s.name for s in PR.spans()[-4:]]
    assert order == ["test.inner", "test.own", "test.outer", "test.alone"]


def test_the_ring_keeps_the_last_spans():
    for i in range(PR.SPAN_RING + 10):
        with PR.span("test.ring", i):
            pass
    kept = PR.spans()
    assert len(kept) == PR.SPAN_RING
    assert [s.trace_id for s in kept[-3:]] == [PR.SPAN_RING + 7,
                                               PR.SPAN_RING + 8,
                                               PR.SPAN_RING + 9]
    assert kept[0].trace_id == 10


def test_a_span_raised_through_is_recorded_and_closed():
    with pytest.raises(ValueError):
        with PR.span("test.raised", 3):
            raise ValueError("inside")
    with PR.span("test.after"):
        pass
    assert _named("test.raised")[-1].trace_id == 3
    assert _named("test.after")[-1].parent is None


def test_threads_keep_their_own_nesting():
    """More threads than cores record nested spans at a short switch
    interval: every record is kept, and each inner span names its own
    thread's outer span and id."""
    n, each = 2 * (os.cpu_count() or 1) + 2, 100
    assert 2 * n * each <= PR.SPAN_RING
    start = threading.Barrier(n)

    def work(t):
        start.wait(timeout=30)
        for i in range(each):
            with PR.span(f"test.thread{t}", (t, i)):
                with PR.span("test.thread_inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    recs = PR.spans()[-2 * n * each:]
    inner = [s for s in recs if s.name == "test.thread_inner"]
    outer = {s.trace_id: s for s in recs if s.name.startswith("test.thread")
             and s.name != "test.thread_inner"}
    assert len(inner) == len(outer) == n * each
    for s in inner:
        t, _ = s.trace_id
        assert s.parent == f"test.thread{t}"
        o = outer[s.trace_id]
        assert o.start_ns <= s.start_ns <= s.end_ns <= o.end_ns


def test_spans_share_the_profilers_clock():
    """A span around a matmul encloses the op's profiler record, and, at
    the best of twenty tries at each end (a shared host can stall any one),
    within 50 us of it."""
    from torch.profiler import ProfilerActivity, profile
    tries = 20
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        a = torch.randn(32, 32)
        a @ a
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            a @ a       # the profiler's first op costs it more
            for i in range(tries):
                with PR.span("test.mm", i):
                    a @ a
    finally:
        torch.set_num_threads(threads)
    ops = sorted((e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm")[1:]
    spans = _named("test.mm")[-tries:]
    assert len(ops) == tries
    for s, (start, end) in zip(spans, ops):
        assert s.start_ns <= start and end <= s.end_ns
    assert min(start - s.start_ns for s, (start, _) in zip(spans, ops)) \
        < 50_000
    assert min(s.end_ns - end for s, (_, end) in zip(spans, ops)) < 50_000


def test_maybe_trace_writes_the_blocks_spans(tmp_path):
    with PR.span("test.before"):
        pass
    with PR.maybe_trace(str(tmp_path), name="spans"):
        a = torch.ones(64, 64)
        with PR.span("test.traced", 5):
            a @ a
    with open(tmp_path / "spans.json") as f:
        events = json.load(f)["traceEvents"]
    mm = next(e for e in events if e.get("name") == "aten::mm")
    traced = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in traced] == ["test.traced"]
    span = traced[0]
    assert span["args"] == {"trace_id": 5, "parent": None}
    # on the trace's own time base, around the op
    assert span["ts"] - 1 <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= span["ts"] + span["dur"] + 1


def test_the_kernels_stages_are_the_stages_in_order():
    with open(os.path.join(_build.CSRC, "stage_mark.cu")) as f:
        src = f.read()
    listed = re.search(r"#define STAGE_MARKS\(X\)(.*?)\n\n", src, re.S)
    assert tuple(re.findall(r"X\((\w+)\)", listed.group(1))) == PR.STAGES
    assert "stage_mark" in _build.SOURCES
    assert set(_build.SIGNATURES["stage_mark"]) == {"cocosnet_stage_mark"}


def test_a_mark_off_the_card_launches_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "library", refuse)
    for stage in PR.STAGES:
        PR.mark(stage, torch.device("cpu"))
        PR.mark(stage, "cpu")
    with pytest.raises(KeyError):
        PR.mark("no_such_stage", "cpu")


@pytest.fixture
def marks(monkeypatch):
    got = []

    def record(stage, device):
        assert stage in PR.STAGES
        assert torch.device(device).type == "cpu"
        got.append(stage)
    monkeypatch.setattr(PR, "mark", record)
    return got


def _batch(b, seed=0):
    rs = np.random.RandomState(seed)
    return {"label": rs.randint(0, 6, (b, 64, 64, 1)).astype(np.float32),
            "image": (rs.rand(b, 64, 64, 3) * 2 - 1).astype(np.float32),
            "ref": (rs.rand(b, 64, 64, 3) * 2 - 1).astype(np.float32),
            "label_ref": rs.randint(0, 6, (b, 64, 64, 1)).astype(np.float32),
            "self_ref": np.ones((b,), np.float32)}


def test_the_serve_forward_marks_its_stages(marks, torch_threads):  # noqa: F811
    opt = TCFG.test_defaults(**MODEL, batchSize=1, isTrain=False)
    nets = TP.Pix2PixNets(opt, device="cpu")
    step = SV.make_serve_step(nets, 1)
    out = step(_batch(1))
    assert out.dtype == torch.uint8
    assert marks == ["prep", "corr", "gen", "end"]


def test_a_fused_train_step_marks_every_stage_in_order(marks,
                                                       torch_threads):  # noqa: F811
    opt = TCFG.test_defaults(**MODEL, batchSize=2, isTrain=True,
                             use_ema=True, vgg_normal_correct=True,
                             weight_mask=100.0)
    nets = TP.Pix2PixNets(opt, device="cpu")
    state = TS.create_train_state(opt, nets)
    step = TST.make_train_step(nets)
    losses, _ = step.fused(state, _batch(2))
    assert all(torch.isfinite(v) for v in losses.values())
    assert tuple(marks) == PR.STAGES
