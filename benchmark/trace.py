"""A traced segment of a run: torch.profiler over a fixed amount of the
window's own work, reduced to the device's kernel records, the time in
which some operation ran on the device, the idle gaps labelled by what the
host was doing, and the device operations that took most time.

At the head of each session PAD_LAUNCHES launches of a kernel no path of
the port runs go first and are left out of the records: on the H100 a
session after CUDA graphs has been seen to lose the records at its head
(the same padding as the port's utils/profiling.py).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

import torch

from benchmark import counts

PAD_LAUNCHES = 512
PAD_KERNEL = "digamma"
TOP = 10
# the harness's own host spans (torch.profiler.record_function in
# modes.py): the profiler also puts them on the device's timeline, where
# they are no device operation
SPANS = frozenset({"serve.dispatch", "serve.wait", "request", "train.chunk",
                   "train.read_losses"})


@dataclass
class Trace:
    units: int = 0                     # forwards, steps or requests traced
    window_s: float = 0.0              # host clock over the traced work
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    head_lost: int = 0

    @property
    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        busy, last = 0.0, float("-inf")
        for _, start, end in sorted(self.kernels, key=lambda k: k[1]):
            busy += max(0.0, end - max(start, last))
            last = max(last, end)
        return busy / 1e6

    def family_s(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, start, end in self.kernels:
            fam = counts.family(name)
            out[fam] = out.get(fam, 0.0) + (end - start) / 1e6
        return out

    def records(self, markers) -> int:
        return sum(1 for name, _, _ in self.kernels
                   if any(m in name for m in markers))

    def host_s(self, span: str) -> List[float]:
        """Per host span of that name: its length less the time in which
        some device operation ran inside it."""
        kernels = sorted(self.kernels, key=lambda k: k[1])
        out = []
        for name, s, e in self.host:
            if name != span:
                continue
            busy, last = 0.0, s
            for _, ks, ke in kernels:
                if ks >= e:
                    break
                if ke > last:
                    busy += min(ke, e) - max(ks, last)
                    last = min(ke, e)
            out.append((e - s - busy) / 1e6)
        return out

    def breakdown(self) -> dict:
        ops: Dict[str, float] = {}
        for name, start, end in self.kernels:
            ops[name[:160]] = ops.get(name[:160], 0.0) + (end - start) / 1e6
        gaps: Dict[str, float] = {}
        last = None
        for _, start, end in sorted(self.kernels, key=lambda k: k[1]):
            if last is not None and start > last:
                label = self._host_at(last, start)
                gaps[label] = gaps.get(label, 0.0) + (start - last) / 1e6
            last = end if last is None else max(last, end)

        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(ops), "idle_gaps": top(gaps)}

    def _host_at(self, start: float, end: float) -> str:
        """The innermost host span or op running at the gap's middle."""
        mid = (start + end) / 2
        inside = [(e - s, name) for name, s, e in self.host if s <= mid <= e]
        return min(inside)[1] if inside else "no host op"


def _pad() -> None:
    x = torch.ones(1, device="cuda")
    out = torch.empty_like(x)
    for _ in range(PAD_LAUNCHES):
        torch.digamma(x, out=out)
    torch.cuda.synchronize()


@contextlib.contextmanager
def traced(units: int) -> Iterator[Trace]:
    """Profiles the block, which runs `units` units of the window's work;
    the record is filled in when the block ends."""
    from torch.profiler import ProfilerActivity, profile
    rec = Trace(units=units)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad()
        t0 = time.perf_counter()
        yield rec
        torch.cuda.synchronize()
        rec.window_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() != cuda:
            host.append(item)
        elif e.name() not in SPANS:
            kernels.append(item)
    pads = [k for k in kernels if PAD_KERNEL in k[0]]
    rec.head_lost = PAD_LAUNCHES - len(pads)
    after = max((k[2] for k in pads), default=float("-inf"))
    rec.kernels = [k for k in kernels
                   if PAD_KERNEL not in k[0] and k[1] >= after]
    rec.host = [h for h in host if h[2] >= after]
