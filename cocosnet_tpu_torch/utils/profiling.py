"""Profiling and measuring: the port's counterpart of
cocosnet_tpu/utils/profiling.py, with torch.profiler in place of
jax.profiler; the port's own tracing (stage marks on the device, host spans
on the request path); and the measuring helpers that chip_smoke.py and the
profile twins (tools/profile_inference.py, tools/profile_train.py) share:
the card's published peaks, CUDA-event and profiler timers, the least time
of a call (bytes over the memory rate, operations over the peak rate), the
operation counts of the hand-written kernels and the device time of a call
by kernel family.

Usage (the train twin traces its third step under --profile_dir):
    with maybe_trace(opt.profile_dir, enabled=(i == 2)):
        losses, visuals = train_step(state, batch, lr)

The trace is a Chrome trace (chrome://tracing, Perfetto) of the host's ops,
the block's host spans and, on a CUDA device, the kernels' device time, the
stage marks among them.

Both instruments are always on:

- `mark(stage, device)` launches the stage's empty one-thread kernel,
  `stage_mark_<stage>` (csrc/stage_mark.cu), on the device's current
  stream where a stage of a forward or a train step begins. A CUDA graph
  captures it like any kernel, so each replay records it in a device trace:
  a stage's device time is that of the device operations from its mark to
  the next one. It costs one device record of about a microsecond; off the
  card it does nothing.
- `with span(name, trace_id):` records (name, start_ns, end_ns, trace_id,
  parent) on time.time_ns(), the clock of torch.profiler's host and device
  records, into a ring of the last SPAN_RING records: two clock reads and
  an append. `spans()` returns them. They stay out of torch.profiler, whose
  record_function ranges would also land on the device's timeline.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import torch

# published peaks of one H100 SXM (dense): bytes/s of HBM3, f32 FLOP/s
# outside the tensor cores, bf16 and TF32 FLOP/s on the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
TF32_FLOP_S = 495e12
# tensor-core passes per product of a split-precision product: 3xTF32 (what
# the correlation kernels issue, csrc/tc_split.cuh) or bf16x3 (the split of
# the TPU kernels, pallas_shift9._dot3 and pallas_corr._dot, and the
# cheapest that holds the dense correlation's tolerances,
# tests/test_torch_corr_split.py)
SPLIT_PASSES = 3
TIMED_RUNS = 25


# ------------------------------------------------------------- the tracing

# the stages of a forward (prep, corr, gen, end) and of a fused train step
# (all of them), in the order they run; csrc/stage_mark.cu holds a kernel
# per stage in this order
STAGES = ("prep", "corr", "gen", "losses", "loss_backward", "net_backward",
          "g_update", "d_step", "end")
MARK_KERNEL = "stage_mark_"
_STAGE_INDEX = {s: i for i, s in enumerate(STAGES)}


def mark(stage: str, device) -> None:
    """Launches stage `stage`'s mark on `device`'s current stream (inside a
    capture, into the graph); nothing where `device` is not a CUDA
    device."""
    index = _STAGE_INDEX[stage]
    if torch.device(device).type != "cuda":
        return
    from cocosnet_tpu_torch.ops import _build
    lib = _build.library("stage_mark")
    err = lib.cocosnet_stage_mark(
        index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, f"stage mark {stage}")


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    trace_id: object
    parent: Optional[str]


SPAN_RING = 4096
_spans: "collections.deque[Span]" = collections.deque(maxlen=SPAN_RING)
_open = threading.local()


class span:
    """`with span(name, trace_id):` records the block's Span. Without a
    trace_id a span takes its parent's (the innermost span open on this
    thread), so the parts of one call share its id."""

    __slots__ = ("name", "trace_id", "parent", "start_ns")

    def __init__(self, name: str, trace_id=None):
        self.name, self.trace_id = name, trace_id

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.trace_id is None and outer is not None:
            self.trace_id = outer.trace_id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _open.stack.pop()
        _spans.append(Span(self.name, self.start_ns, end_ns, self.trace_id,
                           self.parent))
        return False


def spans() -> List[Span]:
    """The ring's spans, oldest first."""
    return list(_spans)


@contextlib.contextmanager
def maybe_trace(logdir: Optional[str], enabled: bool = True,
                name: str = "trace") -> Iterator[None]:
    """Profiles the block into <logdir>/<name>.json when logdir is set and
    enabled is true, with the block's host spans beside the profiler's
    records; otherwise does nothing."""
    if not (logdir and enabled):
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        start_ns = time.time_ns()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        end_ns = time.time_ns()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{name}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in spans()
                      if s.start_ns >= start_ns and s.end_ns <= end_ns])
    print(f"wrote the profile to {path}")


def _add_spans(path: str, block: List[Span]) -> None:
    """The spans into the Chrome trace at `path`, as complete events on a
    row of their own, on the trace's time base (its events' ts are us
    after baseTimeNanoseconds)."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "program spans"}})
    for s in block:
        events.append({"ph": "X", "cat": "program_span", "name": s.name,
                       "pid": pid, "tid": 0,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"trace_id": s.trace_id,
                                "parent": s.parent}})
    with open(path, "w") as f:
        json.dump(trace, f, default=str)


# ------------------------------------------------------------------ timers

def time_ms(fn, runs: int = TIMED_RUNS, warmups: int = 2) -> float:
    """Median over `runs` CUDA-event-timed calls, after `warmups`
    calls."""
    for _ in range(warmups):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def host_ms(fn, runs: int = TIMED_RUNS, warmups: int = 1) -> float:
    """Median over `runs` host-clocked calls after `warmups` calls: the
    timer of the CPU, where there are no CUDA events."""
    for _ in range(warmups):
        fn()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t))
    times.sort()
    return times[len(times) // 2]


# Launches of a kernel no path of the port runs, issued at the head of
# each profiler session and left out of its records. On the H100 a session
# has lost records at its head: the first dozen kernels of a forward (a
# one-hot conv's launch among them) one time in three, and, after
# chip_smoke.py's CUDA graphs, every record of a session of a few dozen
# kernels. The burst takes the loss; `head_lost` counts what it lost.
PAD_LAUNCHES = 512
# profiles of a stage taken before measure_stage gives up on the profiler
PROFILE_TRIES = 3
PAD_KERNEL = "digamma"


def _pad_session() -> None:
    """PAD_LAUNCHES launches of the digamma kernel, then a synchronize."""
    x = torch.ones(1, device="cuda")
    out = torch.empty_like(x)
    for _ in range(PAD_LAUNCHES):
        torch.digamma(x, out=out)
    torch.cuda.synchronize()


def _device_events(prof, device=torch.autograd.DeviceType.CUDA):
    """([(name, start us, end us)] of the session's device events but the
    padding's, the padding's records lost at the session's head), read from
    the profiler's raw (kineto) events: building prof.events()' tree of a
    train step's 60000 events took seconds of the host."""
    kernels = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == device]
    pads = sum(1 for k in kernels if PAD_KERNEL in k[0])
    return ([k for k in kernels if PAD_KERNEL not in k[0]],
            PAD_LAUNCHES - pads)


def device_ms(fn, keys, runs: int = 10) -> dict:
    """Device time per call of `fn`'s kernels whose names hold each of
    `keys`, from torch.profiler over `runs` calls after a warm-up: the
    launches' own time, without the host's time between them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_session()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    kernels, _ = _device_events(prof)
    us = dict.fromkeys(keys, 0.0)
    for name, start, end in kernels:
        for k in keys:
            if k in name:
                us[k] += end - start
    # None where the profiler saw no device kernel of fn's at all
    return {k: v / runs / 1e3 if kernels else None for k, v in us.items()}


# ------------------------------------------------------------------ bounds

def bound_ms(nbytes: int, ops: float, rate: float):
    """(least time in ms, what bounds it) for moving nbytes once and doing
    `ops` operations at `rate` per second."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tc_bound(nb: int, flops: float):
    """(least time in ms, what bounds it, the 3xTF32 bound in ms, the
    f32-FMA bound in ms) of a correlation kernel's `flops`: the least time
    is that of the split the TPU kernels multiply in, bf16x3 (SPLIT_PASSES
    tensor-core passes at the bf16 rate); beside it the split the CUDA
    kernels issue, 3xTF32 (as many passes at the TF32 rate), and the same
    flops at the f32 FMA rate, the bound of a design without tensor
    cores."""
    bms, by = bound_ms(nb, SPLIT_PASSES * flops, BF16_FLOP_S)
    return (bms, by, bound_ms(nb, SPLIT_PASSES * flops, TF32_FLOP_S)[0],
            bound_ms(nb, flops, F32_FLOP_S)[0])


# -------------------------------------- operation counts of the kernels
# The work each hand-written kernel's function needs (what the bounds
# divide, and what the profile twins add for a kernel the FLOP counter
# cannot see), then what its tiles issue.

def conv3x3_flops(b, h, w, ci, co) -> float:
    """A 3x3 'same' conv (csrc/conv3x3.cu forward and dx, conv3x3_dw.cu's
    dW): 2 B H W 9 Cin Cout."""
    return 2.0 * b * h * w * 9 * ci * co


def onehot_ops(b, h, w, co) -> float:
    """The gather conv on integer labels (csrc/conv3x3_onehot.cu): one f32
    add per tap and output, 9 B H W Cout."""
    return 9.0 * b * h * w * co


def shift9_fwd_flops(b, nq, nk, c, d) -> float:
    """The shift9 forward (csrc/shift9_fwd.cu) on C-channel features: S3 =
    F3 G3^T over 3C and P V over D, 2 B Nq Nk (3C + D)."""
    return 2.0 * b * nq * nk * (3 * c + d)


def shift9_bwd_flops(b, nq, nk, c, d) -> float:
    """The shift9 backward (csrc/shift9_bwd.cu): S3 and dP = gO V^T once
    each, then dF3 = dS3 G3, dG3 = dS3^T F3 and dV = P^T gO, 2 B Nq Nk
    (3 x 3C + 2 D)."""
    return 2.0 * b * nq * nk * (9 * c + 2 * d)


def corr_fwd_flops(b, n, m, c, d) -> float:
    """The dense correlation forward (csrc/corr_fwd.cu): 2 B N M (C + D)."""
    return 2.0 * b * n * m * (c + d)


def corr_bwd_flops(b, n, m, c, d) -> float:
    """The dense correlation backward (csrc/corr_bwd.cu): S and dP once
    each, then dq, dk and dv, 2 B N M (3 C + 2 D)."""
    return 2.0 * b * n * m * (3 * c + 2 * d)


def _up(x, t):
    return -(-x // t) * t


def shift9_bwd_issued(b, n, c3, d):
    """The flops csrc/shift9_bwd.cu issues per pass: S3 and dP on the
    128-square regions of the 124-square tiles that cover N padded to 128,
    over 3C and D padded to 32-wide chunks, then dF3 and dG3 over 3C padded
    to 128-column tiles and dV over D padded to 96-column tiles (32 where D
    <= 32), all over N padded to 128."""
    npad = _up(n, 128)
    region = _up(npad, 124) // 124 * 128
    return (2.0 * b * region * region * (_up(c3, 32) + _up(d, 32))
            + 2.0 * b * npad * npad * (2 * _up(c3, 128)
                                       + _up(d, 96 if d > 32 else 32)))


def shift9_fwd_issued(b, n, c3, d):
    """The flops csrc/shift9_fwd.cu issues per pass: S3 over 3C padded to
    32-wide chunks and P V over D padded to its chunks (8, 32 or 160
    columns, S3 again for each chunk), on 128-row query regions of
    126-query tiles and 64-column key regions of 62-key ones."""
    dch = 8 if d <= 8 else 32 if d <= 32 else 160
    rows, cols = -(-n // 126) * 128, -(-n // 62) * 64
    return 2.0 * b * rows * cols * -(-d // dch) * (_up(c3, 32) + dch)


def corr_fwd_issued(b, n, m, c, d):
    """The flops csrc/corr_fwd.cu issues per pass: S over C padded to
    32-wide chunks and P v over D padded to its chunks (8, 32 or 160
    columns), over N padded to 128 and M to 64."""
    dch = 8 if d <= 8 else 32 if d <= 32 else 160
    return 2.0 * b * _up(n, 128) * _up(m, 64) * (_up(c, 32) + _up(d, dch))


def corr_bwd_issued(b, n, m, c, d, dv_cols):
    """The flops the correlation backward kernels issue per pass: the
    scores over C and over D padded to 32-wide chunks, dq and dk over C
    padded to 128-column tiles, dv over D padded to its dv_cols-column
    tiles, all over N and M padded to 128-row tiles."""
    npad, mpad = _up(n, 128), _up(m, 128)
    return 2.0 * b * npad * mpad * (_up(c, 32) + _up(d, 32)
                                    + 2 * _up(c, 128) + _up(d, dv_cols))


# The hand-written kernels' cores, the functions that do a wrapper's work
# (the kernel on a CUDA tensor, its plain version on a CPU one), with the
# operation count of one call from its arguments; `count_flops` replaces
# what the FLOP counter saw inside them by that count.
def _conv_core(x, kernel, *_, **__):
    b, h, w, ci = x.shape
    return conv3x3_flops(b, h, w, ci, kernel.shape[-1])


def _onehot_core(labels, kernel, *_, **__):
    b, h, w = labels.shape[:3]
    return onehot_ops(b, h, w, kernel.shape[-1])


def _shift9_fwd_core(f3, g3, v, *_):
    return shift9_fwd_flops(f3.shape[0], f3.shape[1], g3.shape[1],
                            f3.shape[2] // 3, v.shape[-1])


def _shift9_bwd_core(f3, g3, v, *_):
    return shift9_bwd_flops(f3.shape[0], f3.shape[1], g3.shape[1],
                            f3.shape[2] // 3, v.shape[-1])


def _corr_fwd_core(q, k, v, *_):
    return corr_fwd_flops(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                          v.shape[-1])


def _corr_bwd_core(q, k, v, *_):
    return corr_bwd_flops(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                          v.shape[-1])


def _dw_core(x, g, *_, **__):
    b, h, w, ci = x.shape
    return conv3x3_flops(b, h, w, ci, g.shape[-1])


KERNEL_CORES = (            # (module, (core names), count of one call)
    ("cocosnet_tpu_torch.ops.conv3x3", ("_conv3x3_kernel", "conv3x3_plain"),
     _conv_core),
    ("cocosnet_tpu_torch.ops.conv3x3", ("_onehot_kernel", "onehot_plain"),
     _onehot_core),
    ("cocosnet_tpu_torch.ops.conv3x3",
     ("_conv3x3_dw_kernel", "conv3x3_dw_plain"), _dw_core),
    ("cocosnet_tpu_torch.ops.shift9",
     ("shift9_core_kernel", "shift9_core_plain"), _shift9_fwd_core),
    ("cocosnet_tpu_torch.ops.shift9",
     ("shift9_bwd_kernel", "shift9_bwd_plain"), _shift9_bwd_core),
    ("cocosnet_tpu_torch.ops.corr", ("corr_fwd_kernel", "corr_fwd_plain"),
     _corr_fwd_core),
    ("cocosnet_tpu_torch.ops.corr", ("corr_bwd_kernel", "corr_bwd_plain"),
     _corr_bwd_core),
    # ops/corr_bigc binds ops/corr's cores under its own names
    ("cocosnet_tpu_torch.ops.corr_bigc", ("corr_fwd_kernel", "corr_fwd_plain"),
     _corr_fwd_core),
    ("cocosnet_tpu_torch.ops.corr_bigc", ("corr_bigc_bwd_kernel",
                                          "corr_bwd_plain"), _corr_bwd_core),
)


def count_flops(fn: Callable[[], object]) -> Dict[str, float]:
    """FLOPs of one call of fn: {"library": what torch.utils.flop_counter
    counts (its registry of operator formulas, as FlopCounterMode applies
    it, without the per-module tracking, which costs seconds a train step)
    outside the hand-written kernels' cores, "kernels": the cores'
    operation counts by the formulas above}. The counter cannot see a
    custom kernel, and on the CPU it would count a plain version's own
    arithmetic: inside a core, what it counts is dropped and the formula
    counts instead. A core that calls another core (ops/corr_bigc's
    backward calls ops/corr's kernel) counts once, at the outermost."""
    import importlib
    from unittest import mock

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Counter(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.total += formula(*args, **kwargs, out_val=out)
            return out

    counter = Counter()
    tally = {"inside": 0.0, "kernels": 0.0, "depth": 0}

    def spy(real, count):
        def wrapped(*args, **kw):
            if tally["depth"]:
                return real(*args, **kw)
            tally["depth"] += 1
            before = counter.total
            try:
                return real(*args, **kw)
            finally:
                tally["depth"] -= 1
                tally["inside"] += counter.total - before
                tally["kernels"] += count(*args, **kw)
        return wrapped

    with contextlib.ExitStack() as stack:
        for module, names, count in KERNEL_CORES:
            mod = importlib.import_module(module)
            for name in names:
                stack.enter_context(mock.patch.object(
                    mod, name, spy(getattr(mod, name), count)))
        with counter:
            fn()
    return {"library": counter.total - tally["inside"],
            "kernels": tally["kernels"]}


# ------------------------------------------------- device time by family

KERNEL_FAMILIES = (          # (family, substrings of the kernel name)
    ("conv3x3.cu", ("conv3x3_bf16_kernel", "conv3x3_f32_kernel")),
    ("conv operand copies", ("pad_channels", "k_major_weights")),
    ("conv3x3_onehot.cu", ("onehot::",)),
    ("shift9_fwd.cu", ("shift9_fwd::",)),
    ("shift9_bwd.cu", ("shift9_bwd_scores_kernel", "shift9_bwd_reduce_kernel",
                       "shift9_bwd::src")),
    ("corr_fwd.cu", ("corr_fwd_kernel",)),
    ("corr_bwd.cu", ("corr_bwd_scores_kernel", "corr_bwd::src")),
    ("conv3x3_dw.cu", ("conv3x3_dw_bf16_kernel", "conv3x3_dw_f32_kernel",
                       "reduce_splits")),
    ("library conv (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                              "implicit")),
    ("library matmul", ("gemm", "cutlass", "cublas")),
    ("optimizer (Adam, EMA)", ("multi_tensor", "adam")),
    ("softmax / reductions", ("softmax", "reduce", "norm")),
)
ELEMENTWISE = "elementwise / other"

# (source, ((substring of the kernel name, part), ...)): the launches of
# the kernels that make more than one: the shift9 forward's two and the
# one-hot conv's two, the shift9 backward's five and the correlation
# backward's four (the GEMMs of tc_split.cuh, named after their source;
# dV's and dv's tiles: 96 columns where D > 32, as at the flagship, else
# 32, as in bench_corr)
KERNEL_PARTS = (
    ("shift9_fwd.cu", (("shift9_fwd::shift9_fwd_kernel",
                        "flash (S3, softmax, P V)"),
                       ("shift9_fwd::shift9_fwd_combine_kernel",
                        "combine of the key parts"))),
    ("conv3x3_onehot.cu", (("onehot::onehot_kernel", "gather"),
                           ("onehot::moments_kernel", "moments"))),
    ("shift9_bwd.cu", (("shift9_bwd_scores_kernel", "scores (P, dS3)"),
                       ("shift9_bwd_reduce_kernel", "side gradients"),
                       ("<shift9_bwd::Src, true, 4>", "dF3 = dS3 G3"),
                       ("<shift9_bwd::Src, false, 4>", "dG3 = dS3^T F3"),
                       ("<shift9_bwd::Src, false, 3>", "dV = P^T gO"),
                       ("<shift9_bwd::Src, false, 1>",
                        "dV = P^T gO (32-column tiles)"))),
    ("corr_bwd.cu", (("corr_bwd_scores_kernel", "scores (P, dS)"),
                     ("<corr_bwd::Src, true, 4>", "dq = dS k"),
                     ("<corr_bwd::Src, false, 4>", "dk = dS^T q"),
                     ("<corr_bwd::Src, false, 3>", "dv = P^T gO"),
                     ("<corr_bwd::Src, false, 1>",
                      "dv = P^T gO (32-column tiles)"))))

# (family, the substrings of the one launch each call of its entries makes
# exactly once, the counted entries of its wrappers): a profile's records
# of each hand-written kernel, held against the wrappers' launch counts
KERNEL_CALLS = (
    ("conv3x3.cu", ("conv3x3_bf16_kernel", "conv3x3_f32_kernel"),
     ("conv3x3_fused", "conv3x3_fused_stats", "conv3x3_fused_backward")),
    ("conv3x3_onehot.cu", ("onehot::onehot_kernel",), ("conv3x3_onehot",)),
    ("shift9_fwd.cu", ("shift9_fwd::shift9_fwd_kernel",), ("attend_shift9",)),
    ("shift9_bwd.cu", ("shift9_bwd_scores_kernel",),
     ("attend_shift9_backward",)),
    ("corr_fwd.cu", ("corr_fwd_kernel",), ("attend_corr", "attend_corr_bigc")),
    ("corr_bwd.cu", ("corr_bwd_scores_kernel",),
     ("attend_corr_backward", "attend_corr_bigc_backward")),
    ("conv3x3_dw.cu", ("conv3x3_dw_bf16_kernel", "conv3x3_dw_f32_kernel"),
     ("conv3x3_dw",)),
)


def counted_entries() -> Dict[str, Callable]:
    """The hand-written kernels' wrapper entries, by name: each adds one to
    its `launches` where it launches its kernel (and to `plain_calls` where
    a CPU tensor runs its plain version)."""
    from cocosnet_tpu_torch.ops import conv3x3 as C
    from cocosnet_tpu_torch.ops import corr as Kc
    from cocosnet_tpu_torch.ops import corr_bigc as KB
    from cocosnet_tpu_torch.ops import shift9 as S
    return {"attend_shift9": S.attend_shift9,
            "attend_shift9_backward": S.attend_shift9_backward,
            "attend_corr": Kc.attend_corr,
            "attend_corr_backward": Kc.attend_corr_backward,
            "attend_corr_bigc": KB.attend_corr_bigc,
            "attend_corr_bigc_backward": KB.attend_corr_bigc_backward,
            "conv3x3_fused": C.conv3x3_fused,
            "conv3x3_fused_backward": C.conv3x3_fused_backward,
            "conv3x3_fused_stats": C.conv3x3_fused_stats,
            "conv3x3_onehot": C.conv3x3_onehot,
            "conv3x3_dw": C.conv3x3_dw}


def kernel_breakdown(fn, warmup: bool = True) -> Optional[dict]:
    """One profiled call of `fn` (after a warm-up call unless `warmup` is
    False, where the caller has just run it), from torch.profiler's CUDA
    kernel events: {"kernels": their number, "busy_ms": the union of their
    intervals, "wall_ms": the host-timed call, "families": {family: (launches,
    ms)}, "parts": {(source, part): ms}, "calls": {family: the launches of
    its once-a-call kernel (KERNEL_CALLS)}, "head_lost": the padding's
    records lost at the session's head (_pad_session)}; None where the
    profiler saw no device kernel of fn's."""
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_session()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    kernels, head_lost = _device_events(prof)
    if not kernels:
        return None
    busy, last = 0.0, float("-inf")
    for _, start, end in sorted(kernels, key=lambda k: k[1]):
        busy += max(0.0, end - max(start, last))  # the intervals' union
        last = max(last, end)
    fam = {}
    for name, start, end in kernels:
        low = name.lower()
        key = next((f for f, subs in KERNEL_FAMILIES
                    if any(s in low for s in subs)), ELEMENTWISE)
        n, us = fam.get(key, (0, 0.0))
        fam[key] = (n + 1, us + end - start)
    parts = {}
    for src, keyed in KERNEL_PARTS:
        for key, what in keyed:
            us = sum(end - start for name, start, end in kernels
                     if key in name)
            if us:
                parts[(src, what)] = us / 1e3
    calls = {f: sum(1 for name, _, _ in kernels
                    if any(m in name for m in marks))
             for f, marks, _ in KERNEL_CALLS}
    return dict(kernels=len(kernels), busy_ms=busy / 1e3,
                wall_ms=wall_us / 1e3, parts=parts, calls=calls,
                head_lost=head_lost,
                families={k: (n, us / 1e3) for k, (n, us) in fam.items()})


def missed_calls(prof: dict, launches: Dict[str, int]) -> dict:
    """{family: (the profile's records of its once-a-call kernel, the
    wrappers' launches)} for each hand-written family where the two
    differ: empty when the profile recorded every launch the wrappers
    counted."""
    out = {}
    for fam, _, entries in KERNEL_CALLS:
        want = sum(launches.get(e, 0) for e in entries)
        if prof["calls"][fam] != want:
            out[fam] = (prof["calls"][fam], want)
    return out


def profile_call(fn, warmup: bool = True) -> Optional[dict]:
    """Device time of one call of `fn` by kernel family, from
    torch.profiler's CUDA kernel events, and the device's idle share of the
    host-timed call, printed (after a warm-up call unless `warmup` is
    False); returns kernel_breakdown's record."""
    rec = kernel_breakdown(fn, warmup)
    if rec is None:
        print("profile: not measured (the profiler saw no device kernels)")
        return None
    busy, wall = rec["busy_ms"], rec["wall_ms"]
    total = sum(ms for _, ms in rec["families"].values())
    lost = (f"; the padding lost {rec['head_lost']} records"
            if rec["head_lost"] else "")
    print(f"profile: {rec['kernels']} kernels, device busy {busy:.2f} "
          f"ms of {wall:.2f} ms host time (idle share "
          f"{1 - busy / wall:.3f}{lost}); kernel time by family:")
    for key, (n, ms) in sorted(rec["families"].items(),
                               key=lambda kv: -kv[1][1]):
        print(f"  {key:24s} {n:5d} launches {ms:9.3f} ms "
              f"{ms / total:6.1%}")
    # the kernels' parts, by kernel name and template arguments
    for (src, what), ms in rec["parts"].items():
        print(f"    {src} {what}: {ms:.3f} ms")
    return rec


# --------------------------------------------- the profile twins' stages

def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them
    (`--query-gpu=name,power.limit --format=csv,noheader`), or "cpu"
    without a card."""
    import subprocess
    if not torch.cuda.is_available():
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[torch.cuda.current_device()]


def measure_stage(name: str, fn, iters: int, cuda: bool) -> dict:
    """One stage of a profile twin: the hand-written kernels' calls and
    launches in one call of fn (their wrappers' counts), its FLOPs
    (count_flops), its ms (CUDA events on the card, the host clock on the
    CPU; the median of `iters` after warm-up) and, on the card, its device
    time by kernel family (kernel_breakdown). On the card the profile must
    record each launch of a hand-written kernel that the wrappers counted:
    the profiler can drop records, and a dropped record must not read as
    zero, so a profile that misses one, or records no kernel, is taken
    again, up to PROFILE_TRIES in all, and then raises (a session of a
    VGG19 tower late in chip_smoke.py once recorded no kernel at all). The
    counting call warms the stage up for the timed ones, and these for the
    profiled one; `wall_s` is the host time the stage took in all."""
    t = time.perf_counter()
    entries = counted_entries()
    before = {k: (e.launches, e.plain_calls) for k, e in entries.items()}
    flops = count_flops(fn)
    launches = {k: e.launches - before[k][0] for k, e in entries.items()}
    calls = {k: launches[k] + e.plain_calls - before[k][1]
             for k, e in entries.items()}
    ms = (time_ms if cuda else host_ms)(fn, iters, warmups=1)
    prof = None
    for attempt in range(PROFILE_TRIES if cuda else 0):
        prof = kernel_breakdown(fn, warmup=False)
        missed = ("no device kernel" if prof is None
                  else missed_calls(prof, launches))
        if not missed:
            break
        msg = (f"{name}: the profile missed hand-written launches "
               f"(recorded, launched): {missed}")
        if attempt + 1 == PROFILE_TRIES:
            raise RuntimeError(msg)
        print(msg + "; profiling it again", flush=True)
    return dict(name=name, ms=ms, wall_s=time.perf_counter() - t,
                gflop=(flops["library"] + flops["kernels"]) / 1e9,
                kernel_gflop=flops["kernels"] / 1e9,
                calls={k: n for k, n in calls.items() if n},
                launches={k: n for k, n in launches.items() if n},
                profile=prof)


def print_stage(row: dict, peak_tflops: float) -> None:
    """One stage on one line: ms, GFLOP and the share of the peak, the
    device-busy ms and the elementwise family's ms and launches."""
    prof = row["profile"]
    busy = "not measured" if prof is None else (
        f"busy {prof['busy_ms']:.2f} ms, elementwise "
        f"{prof['families'].get(ELEMENTWISE, (0, 0.0))[1]:.2f} ms "
        f"({prof['families'].get(ELEMENTWISE, (0, 0.0))[0]})")
    lost = (f", the padding lost {prof['head_lost']} records"
            if prof is not None and prof["head_lost"] else "")
    print(f"{row['name']:36s} {row['ms']:9.3f} ms {row['gflop']:9.2f} GFLOP "
          f"{_peak_share(row, peak_tflops):6.2f}% of peak; {busy}; "
          f"hand-written calls {row['calls'] or 'none'} (measured in "
          f"{row['wall_s']:.1f} s{lost})", flush=True)


def _peak_share(row: dict, peak_tflops: float) -> float:
    return (100.0 * row["gflop"] / row["ms"] / peak_tflops
            if row["ms"] > 0 else float("nan"))


def stage_table(rows, full: str, peak_tflops: float, title: str) -> str:
    """Markdown: a line per stage (ms, GFLOP with the hand-written kernels'
    share, the share of `full`'s ms and of the peak, device busy ms, the
    elementwise family, the hand-written calls), then each stage's device
    time by kernel family."""
    full_ms = next(r["ms"] for r in rows if r["name"].strip() == full)

    def fam(r, key):
        n, ms = r["profile"]["families"].get(key, (0, 0.0))
        return f"{ms:.2f} ({n})"

    lines = [title, "",
             f"| stage | ms | GFLOP (hand-written) | % of {full} | % of "
             f"{peak_tflops:g} TFLOP/s | device busy ms (kernels) | "
             "elementwise ms (launches) | hand-written calls |",
             "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        prof = r["profile"]
        busy = ("not measured" if prof is None else
                f"{prof['busy_ms']:.2f} ({prof['kernels']})")
        elem = "not measured" if prof is None else fam(r, ELEMENTWISE)
        calls = ", ".join(f"{k} {n}" for k, n in r["calls"].items())
        lines.append(
            f"| {r['name'].strip()} | {r['ms']:.3f} | {r['gflop']:.2f} "
            f"({r['kernel_gflop']:.2f}) | {100 * r['ms'] / full_ms:.0f}% | "
            f"{_peak_share(r, peak_tflops):.2f}% | {busy} | {elem} | "
            f"{calls or 'none'} |")
    if any(r["profile"] for r in rows):
        lines += ["", "Device ms (launches) by kernel family:", "",
                  "| stage | families |", "|---|---|"]
        for r in rows:
            if r["profile"] is None:
                continue
            fams = sorted(r["profile"]["families"].items(),
                          key=lambda kv: -kv[1][1])
            lines.append(f"| {r['name'].strip()} | " + "; ".join(
                f"{k} {ms:.2f} ({n})" for k, (n, ms) in fams) + " |")
    return "\n".join(lines) + "\n"


def write_report(path: str, text: str) -> None:
    """text into path, its directory made first."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    print(f"wrote {path}")
