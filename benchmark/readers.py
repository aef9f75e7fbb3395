"""What the per-layer metrics' readers (benchmark/metrics/<metric>.py)
share: each takes the run's record (run.py `Run`) and returns its number,
or None where the run has nothing to read."""

from __future__ import annotations

import statistics
from typing import Optional

from benchmark import counts


def family_ms(run, *families: str) -> Optional[float]:
    """Device ms a unit (forward, step or request) in the kernel families,
    from the traced segment."""
    if run.trace is None or not run.trace.kernels:
        return None
    fams = run.trace.family_s()
    if not any(f in fams for f in families):
        return None
    return 1e3 * sum(fams.get(f, 0.0) for f in families) / run.trace.units


def roofline(run, fam: str, *extra: str) -> Optional[float]:
    """% of the least time the family's calls of a unit could take (each
    call's operations at the bf16 peak or its bytes at the HBM rate,
    whichever is longer, counted once at set-up) over their device time in
    the traced segment (with the families in `extra`, the work the same
    wrapper launches beside the kernel). The time per call is the
    family's time over its records of the once-a-call kernel, so a record
    the profiler lost counts neither way."""
    rec = run.counts.get(fam)
    if run.trace is None or not rec or not rec["calls"]:
        return None
    records = run.trace.records(counts.call_markers(fam))
    fams = run.trace.family_s()
    spent = fams.get(fam, 0.0) + sum(fams.get(f, 0.0) for f in extra)
    if not records or spent <= 0:
        return None
    per_call = spent / records
    return 100.0 * rec["bound_s"] / (per_call * rec["calls"])


def mfu(run) -> Optional[float]:
    """% of the bf16 dense peak: the model FLOPs of the window's units
    (counted on the plain reference) over the window's time."""
    w = run.window
    if not run.flops_per_unit or not w.get("seconds"):
        return None
    rate = run.flops_per_unit * w["units"] / w["seconds"]
    return 100.0 * rate / counts.BF16_FLOP_S


def idle_share(run) -> Optional[float]:
    if run.trace is None or not run.trace.kernels:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def host_ms(run, span: str) -> Optional[float]:
    """Median over the traced segment's spans of that name of the span's
    length less the device's busy time inside it, in ms."""
    if run.trace is None or not run.trace.kernels:
        return None
    host = run.trace.host_s(span)
    return 1e3 * statistics.median(host) if host else None


def peak_gib(run) -> Optional[float]:
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
