#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (cocosnet_tpu_torch) on NVIDIA
GPUs: runs one cell of BENCHMARK.json once and prints one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. A cell is its BENCHMARK.json entry, its
traffic file benchmark/workloads/<cell>.json (mode, batch, loop, inputs,
the limits of its comparison) and its configuration file
benchmark/configs/<config>.json (the port's flags and what the plain
reference assumes of them). A per-layer metric is the module
benchmark/metrics/<metric>.py, whose `read(run)` returns its value or
None.

The run makes the weights and the batches from --seed on the card, builds
the port's entry for the cell, warms up and captures only the cell's
shapes (set-up, `setup_s`), measures the window for --seconds, with
--trace 1 profiles a fixed segment of the same work after it, then frees
the program and compares what the window's path produced with the plain
float32 reference (benchmark/reference/). The last line of standard
output is {"correct", "attempted", "failed", "metrics", "device",
["breakdown",] "compared"}; the last lines of standard error give each
compared number beside its limit.

Exits non-zero with no result line without as many CUDA devices as the
cell asks for, or if jax, jaxlib, flax or the JAX package cocosnet_tpu is
loaded once the window has closed. The port's kernels build at first use
into build/kernels/ of the checkout (cocosnet_tpu_torch/ops/_build.py).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import compare, manifest, modes  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "cocosnet_tpu"}


class Run:
    """What one run measured, as the per-layer readers see it."""

    def __init__(self, cell, config, traffic, seed, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device = seed, device
        self.counts = {}            # per unit: {family: calls, ops, ...}
        self.flops_per_unit = 0.0   # model FLOPs of a forward or a step
        self.window = {}
        self.requests = []          # wall s per request of the window
        self.trace = None
        self.peak_bytes = 0


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the plain versions on the CPU, for the benchmark's own tests
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def device_record(run, chips: int, trace_on: bool) -> dict:
    if run.device.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": chips, "memory_peak_bytes": run.peak_bytes}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    if trace_on and run.trace is not None:
        rec.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    return rec


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = manifest.Manifest(args.root)
    entry = bench.cell(args.workload)
    config = bench.config(entry["config"])
    traffic = bench.traffic(args.workload, entry)
    device = torch.device(args.device)
    if device.type == "cuda" and not (
            torch.cuda.is_available()
            and torch.cuda.device_count() >= entry["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    if device.type == "cuda":
        # the load comes from one host thread: the intra-op pool's threads
        # only wait on the card here, and on a shared host they stall the
        # copy-in of a request by milliseconds
        torch.set_num_threads(1)
        torch.cuda.reset_peak_memory_stats()
    run = Run(entry, config, traffic, args.seed, device)
    mode = modes.MODES[traffic["mode"]](run)
    mode.setup()
    modes.sync(device)
    setup_s = time.perf_counter() - T0
    run.window = mode.window(args.seconds)
    if run.requests:
        lat = [1e3 * w for w in run.requests]
        print(f"requests {len(lat)}: wall ms p50 {modes.percentile(lat, 50)} "
              f"p95 {modes.percentile(lat, 95)} p99 "
              f"{modes.percentile(lat, 99)} max {max(lat)}",
              file=sys.stderr, flush=True)
    if args.trace and device.type == "cuda":
        run.trace = mode.traced(traffic["trace_units"])
        per_unit = {f: round(1e3 * s / run.trace.units, 4)
                    for f, s in sorted(run.trace.family_s().items(),
                                       key=lambda kv: -kv[1])}
        print(f"trace: {run.trace.units} units, device ms a unit by family "
              f"{per_unit}; counted calls a unit {run.counts}; padding "
              f"records lost {run.trace.head_lost}", file=sys.stderr)
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    run.flops_per_unit = mode.flops()
    mode.release()
    limits = traffic["limits"]
    found = mode.check()
    readings = {k: found.get(k, float("nan")) for k in limits}
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}; the benchmark runs the port "
              f"alone", file=sys.stderr)
        return 3
    if args.trace:
        metrics = {}
        for m in bench.per_layer(args.workload):
            value = bench.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in bench.end_to_end(args.workload):
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": run.window[m["name"]],
                                      "unit": m["unit"]}
    correct = compare.judge(readings, limits)
    result = {"correct": correct, "attempted": run.window["attempted"],
              "failed": run.window["failed"], "metrics": metrics,
              "device": device_record(run, entry["chips"], bool(args.trace))}
    if args.trace and run.trace is not None and run.trace.kernels:
        result["breakdown"] = run.trace.breakdown()
    result["compared"] = {k: {"value": v, "limit": limits[k]}
                          for k, v in readings.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
