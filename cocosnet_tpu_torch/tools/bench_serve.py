"""Load test of the serve twin (cocosnet_tpu_torch/tools/serve.py): the twin
of tools/bench_serve.py.

Generates N exemplar-translation requests from a directory of (label .png,
photo .jpg) pairs in the ADE20k layout (a synthetic tree's training/
folder serves: `python -m cocosnet_tpu_torch.data.synthetic ROOT`), feeds
them into the server's watch dir, either all at once or at a steady
arrival rate, and measures per-request END-TO-END latency (request files
written -> result file visible) and throughput, independently of the
server's own accounting.

The server is launched as a subprocess (the module
cocosnet_tpu_torch.tools.serve of the checkout this file lies in), as a
deployment would run it, and terminated when all results are in:

  python -m cocosnet_tpu_torch.tools.bench_serve --src_dir ROOT/training \\
      --n_requests 64 --arrival_rate 0 \\
      -- --name s --dataset_mode ade20k --batchSize 6 \\
         --allow_random_weights --checkpoints_dir /tmp/ck

Everything after `--` goes to the server verbatim (plus the watch and out
dirs this script owns). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np


def find_pairs(src_dir):
    """(label.png, photo.jpg) paths available in an ade20k-layout dir."""
    pairs = []
    for f in sorted(os.listdir(src_dir)):
        if f.endswith(".jpg"):
            png = f[:-4] + ".png"
            if os.path.exists(os.path.join(src_dir, png)):
                pairs.append((os.path.join(src_dir, png),
                              os.path.join(src_dir, f)))
    if not pairs:
        raise SystemExit(f"no (png,jpg) pairs under {src_dir}")
    return pairs


def write_request(watch, rid, label_png, ref_label_png, ref_jpg):
    """The .ref.jpg (the watcher's trigger file) lands last, by rename."""
    shutil.copy(label_png, os.path.join(watch, rid + ".label.png"))
    shutil.copy(ref_label_png, os.path.join(watch, rid + ".ref_label.png"))
    tmp = os.path.join(watch, rid + ".ref.jpg.tmp")
    shutil.copy(ref_jpg, tmp)
    os.rename(tmp, os.path.join(watch, rid + ".ref.jpg"))
    return time.perf_counter()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src_dir", required=True,
                    help="dir of (stem.png label, stem.jpg photo) pairs")
    ap.add_argument("--n_requests", type=int, default=64)
    ap.add_argument("--arrival_rate", type=float, default=0.0,
                    help="requests/sec fed to the watch dir; 0 = all upfront")
    ap.add_argument("--warmup", type=int, default=8,
                    help="initial requests excluded from the stats (capture "
                         "and cold caches)")
    ap.add_argument("--timeout_s", type=float, default=1800.0)
    ap.add_argument("--ext", default=None,
                    help="result extension to wait for (defaults to the "
                         "--out_format passed to the server, else png)")
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="-- then the server's args")
    args = ap.parse_args(argv)
    serve_args = [a for a in args.rest if a != "--"]
    if args.ext is None:
        args.ext = (serve_args[serve_args.index("--out_format") + 1]
                    if "--out_format" in serve_args else "png")

    pairs = find_pairs(args.src_dir)
    tmp = tempfile.mkdtemp(prefix="bench_serve_")
    watch = os.path.join(tmp, "in")
    out = os.path.join(tmp, "out")
    os.makedirs(watch)

    # the server runs as a module of the checkout this file lies in, in
    # the caller's working directory (relative paths in its flags hold)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    boot = ("import runpy, sys; sys.path.insert(0, sys.argv.pop(1)); "
            "runpy.run_module('cocosnet_tpu_torch.tools.serve', "
            "run_name='__main__', alter_sys=True)")
    cmd = [sys.executable, "-c", boot, root,
           "--watch_dir", watch, "--out_dir", out,
           "--poll_s", "0.05"] + serve_args
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    # drain the server's output continuously (a long run prints enough
    # 'served N requests' lines to fill the pipe and block the server
    # mid-print otherwise); keep a tail for error reporting
    tail = collections.deque(maxlen=50)

    def _drain():
        for line in proc.stdout:
            tail.append(line)

    drainer = threading.Thread(target=_drain, daemon=True)
    drainer.start()

    t_sent = {}
    try:
        # the warm-up requests first, so that capture time never pollutes
        # the arrivals
        for i in range(args.warmup):
            rid = f"w{i:04d}"
            lp, rp = pairs[i % len(pairs)]
            rlp, _ = pairs[(i + 1) % len(pairs)]
            t_sent[rid] = write_request(watch, rid, lp, rlp, rp)

        def outputs_done(prefix, n):
            for i in range(n):
                err = os.path.join(out, f"{prefix}{i:04d}.error.txt")
                if os.path.exists(err):
                    with open(err) as f:
                        raise SystemExit(f"request failed: {err}: "
                                         + f.read().strip())
            return sum(os.path.exists(
                os.path.join(out, f"{prefix}{i:04d}.{args.ext}"))
                for i in range(n)) == n

        t0 = time.perf_counter()
        while not outputs_done("w", args.warmup):
            if proc.poll() is not None:
                print("".join(tail))
                raise SystemExit("the server exited during warmup")
            if time.perf_counter() - t0 > args.timeout_s:
                raise SystemExit("warmup timeout")
            time.sleep(0.1)

        # measured phase. Completions are timestamped by a CONCURRENT
        # collector thread: detecting them only after the arrival loop
        # would inflate a fixed-rate run's latencies by up to the whole
        # arrival window.
        lat = {}
        t_end_holder = {}
        stop = threading.Event()

        def _collect():
            pending = {f"r{i:04d}" for i in range(args.n_requests)}
            while pending and not stop.is_set():
                done = set()
                for rid in pending:
                    if rid in t_sent and os.path.exists(
                            os.path.join(out, rid + "." + args.ext)):
                        lat[rid] = time.perf_counter() - t_sent[rid]
                        done.add(rid)
                pending -= done
                if done:
                    t_end_holder["t"] = time.perf_counter()
                time.sleep(0.02)

        collector = threading.Thread(target=_collect, daemon=True)
        collector.start()

        period = 1.0 / args.arrival_rate if args.arrival_rate > 0 else 0.0
        t_start = time.perf_counter()
        for i in range(args.n_requests):
            rid = f"r{i:04d}"
            lp, rp = pairs[(i + args.warmup) % len(pairs)]
            rlp, _ = pairs[(i + args.warmup + 1) % len(pairs)]
            t_sent[rid] = write_request(watch, rid, lp, rlp, rp)
            if period:
                next_t = t_start + (i + 1) * period
                time.sleep(max(0.0, next_t - time.perf_counter()))

        deadline = time.perf_counter() + args.timeout_s
        while len(lat) < args.n_requests:
            if proc.poll() is not None:
                print("".join(tail))
                raise SystemExit("the server exited mid-run")
            if time.perf_counter() > deadline:
                raise SystemExit(f"timeout with {len(lat)} done")
            outputs_done("r", args.n_requests)  # raises on any error file
            time.sleep(0.05)
        stop.set()
        collector.join(timeout=5)
        t_end = t_end_holder.get("t", time.perf_counter())
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=15)
        drainer.join(timeout=5)
        shutil.rmtree(tmp, ignore_errors=True)

    ls = np.array(sorted(lat.values())) * 1000.0
    result = {
        "n_requests": args.n_requests,
        "arrival_rate_rps": args.arrival_rate,
        "throughput_rps": round(args.n_requests / (t_end - t_start), 2),
        "latency_ms": {"p50": round(float(np.percentile(ls, 50)), 1),
                       "p90": round(float(np.percentile(ls, 90)), 1),
                       "p99": round(float(np.percentile(ls, 99)), 1),
                       "max": round(float(ls[-1]), 1)},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
