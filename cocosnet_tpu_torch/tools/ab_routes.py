"""A/B of the flagship paths on one GPU, host clock and device time side by
side: one checkout of the port against another (a change against its
parent), or the kernel routes against the library route that the JAX
package's switches select.

One process times one checkout on one route, at chip_smoke.py's flagship
configurations and seeded random weights:
  - mk3 inference, batch 6: the forward by CUDA events (25 runs), batch-1
    p50 end to end with preprocessing (host clock, synchronized); the same
    at match_kernel 1 (the dense correlation, csrc/corr_fwd.cu on the
    default route);
  - the train steps at batch 8 (s/step over 10 steps after 2 warm-ups,
    host clock, synchronized): mk3, and on the default route also mk1 on
    the library route and on attend_corr's kernels
    (COCOSNET_PALLAS_MK1_TRAIN=1), and 5d (COCOSNET_FUSED_CONV_TRAIN=1);
  - for one forward of each and one mk3 step, the device's busy time (the
    union of its kernels in torch.profiler) and idle share of the
    host-timed call.

Routes: "default" (every switch unset) or "library" (COCOSNET_FUSED_CONV=0,
COCOSNET_ONEHOT_CONV=0 and opt.use_pallas False: every hand-written kernel
off, the correlation on ops/corr_shift.attend_unfold). Each process appends
one JSON line to --out. Run checkouts and routes in turns in one call, e.g.
parent, change, change, parent; from the repository root:

    git archive <parent> | tar -x -C build/ab/parent
    python3 cocosnet_tpu_torch/tools/ab_routes.py --root build/ab/parent \\
        --tag parent --out build/ab/routes.jsonl
    python3 cocosnet_tpu_torch/tools/ab_routes.py --tag change \\
        --route library --out build/ab/routes.jsonl

The package is imported from --root (default: this checkout); the
configurations, batches and routes are this checkout's chip_smoke.py, the
timers, the profile reader and the weights' conditioning the package's
(utils/profiling.py, nn/layers.condition_weights), which chip_smoke.py
imports as well: a --root checkout must have them.
--only limits a process to some of the paths (mk3_inference,
mk1_inference, mk3_step, other_steps), for more turns of one path in a
call.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# what one process measures: the two forwards, the mk3 step (with its
# device time), and the other steps of the default route
PATHS = ("mk3_inference", "mk1_inference", "mk3_step", "other_steps")


def _smoke():
    """This checkout's chip_smoke.py as a module (never its main)."""
    spec = importlib.util.spec_from_file_location(
        "_ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def busy(fn) -> dict:
    """Device busy ms (the union of the kernels' intervals), host ms and the
    idle share of one synchronized call of fn, after one warm-up
    (utils/profiling.kernel_breakdown)."""
    from cocosnet_tpu_torch.utils.profiling import kernel_breakdown
    rec = kernel_breakdown(fn)
    if rec is None:
        return dict(busy_ms=None, host_ms=None, idle=None, kernels=0)
    return dict(busy_ms=rec["busy_ms"], host_ms=rec["wall_ms"],
                idle=1 - rec["busy_ms"] / rec["wall_ms"],
                kernels=rec["kernels"])


def inference(CS, P, cfg, L, g, use_pallas, match_kernel=3) -> dict:
    from cocosnet_tpu_torch.utils.profiling import TIMED_RUNS, time_ms
    L.set_compute_dtype(torch.bfloat16)
    opt = dataclasses.replace(CS.inference_opt(cfg, match_kernel),
                              use_pallas=use_pallas)
    nets = P.Pix2PixNets(opt, seed=0)
    L.condition_weights(nets.corr, g, "cuda")
    L.condition_weights(nets.gen, g, "cuda")
    batch = CS.make_batch(g, 6, 256, 256, opt.semantic_nc)
    data = P.preprocess_input(opt, batch)
    fwd_ms = time_ms(lambda: P.inference(nets, data))
    one = {k: v[:1] for k, v in batch.items()}
    lat = []
    for _ in range(TIMED_RUNS + 2):
        t = time.perf_counter()
        P.inference(nets, P.preprocess_input(opt, one))
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t))
    lat = sorted(lat[2:])
    res = dict(fwd_ms=fwd_ms, b1_p50_ms=lat[len(lat) // 2],
               **busy(lambda: P.inference(nets, data)))
    del nets, data
    torch.cuda.empty_cache()
    return res


def train(CS, P, cfg, TS, ST, g, match_kernel, use_pallas, steps=10,
          profiled=False) -> dict:
    opt = CS.train_opt(cfg, label_nc=150, crop_size=256, load_size=256,
                       batchSize=8, ngf=64, ndf=64, match_kernel=match_kernel,
                       use_pallas=use_pallas)
    from cocosnet_tpu_torch.nn.layers import condition_weights
    nets = P.Pix2PixNets(opt, seed=0)
    for net in nets.modules():
        condition_weights(net, g, "cuda")
    state = TS.create_train_state(opt, nets)
    step = ST.make_train_step(nets)
    lr = TS.lrs_for_epoch(opt, 1)
    batch = {k: v.cuda() for k, v in
             CS.make_batch(g, 8, 256, 256, opt.semantic_nc).items()}
    for _ in range(2):
        step(state, batch, lr)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        losses, _ = step(state, batch, lr)
    torch.cuda.synchronize()
    res = dict(s_per_step=(time.perf_counter() - t) / steps,
               finite=all(bool(torch.isfinite(v)) for v in losses.values()))
    if profiled:
        res.update(busy(lambda: step(state, batch, lr)))
    del nets, state, step, batch
    torch.cuda.empty_cache()
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose cocosnet_tpu_torch is timed")
    ap.add_argument("--tag", required=True, help="name of the checkout")
    ap.add_argument("--route", choices=("default", "library"),
                    default="default")
    ap.add_argument("--out", required=True, help="JSON lines, appended")
    ap.add_argument("--only", choices=PATHS, nargs="+", default=PATHS,
                    help="measure these paths only (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_routes: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from cocosnet_tpu_torch import config as cfg
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.nn import layers as L
    from cocosnet_tpu_torch.ops import _build
    from cocosnet_tpu_torch.train import state as TS
    from cocosnet_tpu_torch.train import steps as ST
    if args.route == "library":       # the gates read them at each call
        os.environ[L.FUSED_ENV] = "0"
        os.environ[L.ONEHOT_ENV] = "0"
    CS = _smoke()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    use_pallas = args.route == "default"
    g = torch.Generator().manual_seed(0)
    rec = dict(tag=args.tag, route=args.route, build_s=build_s)
    for mk in (3, 1):
        if f"mk{mk}_inference" in args.only:
            rec[f"mk{mk}_inference"] = inference(CS, P, cfg, L, g,
                                                 use_pallas, mk)
    L.set_compute_dtype(torch.bfloat16)
    if "mk3_step" in args.only:
        rec["mk3_step"] = train(CS, P, cfg, TS, ST, g, 3, use_pallas,
                                profiled=True)
    if args.route == "default" and "other_steps" in args.only:
        for route in ("library", "kernels"):
            with CS.train_route(route):
                rec[f"mk1_{route}_step"] = train(CS, P, cfg, TS, ST, g, 1,
                                                 True)
        with CS.train_route("fused"):
            rec["fused_5d_step"] = train(CS, P, cfg, TS, ST, g, 3, True,
                                         steps=5)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    rec["gpu"] = smi
    print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
