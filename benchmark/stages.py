"""What the readers of the port's own tracing share
(cocosnet_tpu_torch/utils/profiling.py): the device time of a stage of a
forward or a train step, between the stage marks that the traced segment
recorded, and the host time of a program span of a request.

A stage mark is an empty kernel named stage_mark_<stage>, launched (or
replayed from a CUDA graph) where the stage begins. The device time from
one mark to the next, the union of the device operations that start in
between, is the stage's; operations before a unit's first mark and after
its `end` mark (the copies outside a graph) belong to no stage. A reader
returns None where the program records no spans (it has no tracing of its
own) or where the marks do not repeat as one cycle once a unit: a record
the profiler lost must read as nothing, not as a wrong number.

A program span is recorded on time.time_ns(), the clock of the profiler's
records: a span of a traced request is read as the harness's own `request`
span is (trace.Trace.host_s), its length less the device's busy time
inside it, once the spans that fall outside the traced segment are left
out.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from benchmark import trace as T

MARK = "stage_mark_"


def program_spans() -> Optional[List]:
    """The program's spans, or None where it records none."""
    from cocosnet_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    return spans() if callable(spans) else None


def stage_of(kernel_name: str) -> Optional[str]:
    """The stage a mark's kernel marks, or None for any other kernel."""
    at = kernel_name.find(MARK)
    if at < 0:
        return None
    return kernel_name[at + len(MARK):].split("(", 1)[0]


def partition(kernels) -> Dict[Optional[str], float]:
    """{stage: seconds} over the records: the union of the device
    operations split at each mark (None: before the first mark)."""
    out: Dict[Optional[str], float] = {}
    stage, last = None, float("-inf")
    for name, start, end in sorted(kernels, key=lambda k: k[1]):
        stage = stage_of(name) or stage
        out[stage] = out.get(stage, 0.0) + max(0.0, end - max(start, last))
        last = max(last, end)
    return {k: v / 1e6 for k, v in out.items()}


def cycle(kernels, units: int) -> Optional[List[str]]:
    """The marks of one unit where the records repeat them as one cycle
    of distinct stages, `units` times, else None."""
    seq = [stage_of(name) for name, _, _ in sorted(kernels,
                                                   key=lambda k: k[1])]
    seq = [s for s in seq if s is not None]
    if not units or not seq or len(seq) % units:
        return None
    one = seq[:len(seq) // units]
    if len(set(one)) != len(one) or seq != one * units:
        return None
    return one


def stage_ms(run, *stages: str) -> Optional[float]:
    """Device ms a unit in the stages, from the traced segment."""
    if run.trace is None or not run.trace.kernels \
            or program_spans() is None:
        return None
    one = cycle(run.trace.kernels, run.trace.units)
    if one is None or not set(stages) <= set(one):
        return None
    parts = partition(run.trace.kernels)
    return 1e3 * sum(parts[s] for s in stages) / run.trace.units


def span_ms(run, name: str) -> Optional[float]:
    """Median over the traced units of the program span `name`'s length
    less the device's busy time inside it, in ms; None unless the traced
    segment holds one such span a unit. The segment starts at the first
    host record's end after the padding (trace.traced keeps only those)
    and ends at the last record's end."""
    spans = program_spans()
    tr = run.trace
    if spans is None or tr is None or not tr.kernels or not tr.host:
        return None
    lo = min(h[2] for h in tr.host)
    hi = max(max(h[2] for h in tr.host), max(k[2] for k in tr.kernels))
    inside = [(s.name, s.start_ns / 1e3, s.end_ns / 1e3) for s in spans
              if s.name == name and lo <= s.start_ns / 1e3
              and s.end_ns / 1e3 <= hi]
    if len(inside) != tr.units:
        return None
    host = T.Trace(units=tr.units, kernels=tr.kernels,
                   host=inside).host_s(name)
    return 1e3 * statistics.median(host)
