#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, at the
cell's own sizes, in one process:

- the program: its set-up and a short window of the cell's own load
  (`--seconds`; training reads its first three steps and needs none) on
  each seed, judged as a run judges it;
- the control: the reference in the program's place with every
  convolution's operands rounded to fp8 (compare.fp8_round), on the same
  inputs and weights, against the float32 reference;
- for training, the faults: half of each batch left out (the reference in
  the program's place on the first half of each batch, the mean over it),
  and the same planted in the program's replayed steps alone (the second
  half of each batch the graph is fed is its first half again, so each
  mean is the first half's). A state left unchanged reads change_gap 1
  and an EMA left unchanged ema_gap 1 by definition; they need no run.

Besides the compared numbers, a training row gives the look behind their
forms, against the reference that follows from the start: `loss_gap_3`
(the worst term over the three steps), each third-step term's gap
(`step3.<term>`) and their median (`replay_gap`), and `grad_gap` (the worst leaf's first
gradient norm as the optimizer got it).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        [--control_seeds ...] [--fault_seeds ...] [--seconds 2] [--out F]

Prints one JSON line per (kind, seed) and a summary: the largest program
reading and the smallest control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import statistics
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import compare, inputs, manifest, modes, program  # noqa: E402
from benchmark.reference import model as R  # noqa: E402
from benchmark.reference import train as RT  # noqa: E402
from benchmark.run import Run  # noqa: E402

WARM_UP_STEPS = 2       # the chunk graph's eager steps before its replays


def look(losses, want, grads, want_grads):
    """The readings behind the compared forms (not compared), against the
    reference that follows from the start for three steps."""
    out = {"loss_gap_3": max(max(compare.loss_gaps(g, w).values())
                             for g, w in zip(losses, want))}
    third = compare.loss_gaps(losses[2], want[2])
    out.update((f"step3.{k}", v) for k, v in third.items())
    out["replay_gap"] = statistics.median(third.values())
    if grads is not None:
        kept = set(compare.kept_leaves(want_grads))
        out["grad_gap"] = max(compare.norm_gaps(
            {k: grads[k] for k in kept},
            {k: want_grads[k] for k in kept}).values())
    return out


class Look(modes.Train):
    """The train mode keeping what the look needs: the gradients the
    optimizers got on the first step."""

    def first_step(self) -> None:
        self.grads = {k: float(m.norm()) for k, m in
                      program.first_moments(self.state, self.nets).items()}

    def check(self):
        readings = super().check()
        want, ref_grads = self.independent
        readings.update(look(self.losses, want, self.grads, ref_grads))
        return readings


def _replay_half(real_trainer):
    """program.trainer whose multi step feeds each step after the eager
    warm-up ones a batch whose second half is its first half."""
    def trainer(opt, nets):
        state, multi, lr = real_trainer(opt, nets)
        done = [0]

        def planted(state, batches, lr):
            fed = []
            for b in batches:
                if done[0] >= WARM_UP_STEPS:
                    h = next(iter(b.values())).shape[0] // 2
                    b = {k: torch.cat([v[:h], v[:h]]) for k, v in b.items()}
                fed.append(b)
                done[0] += 1
            return multi(state, fed, lr)
        return state, planted, lr
    return trainer


def program_reading(entry, config, traffic, seed, seconds, device,
                    fault=None):
    run = Run(entry, config, traffic, seed, device)
    train = traffic["mode"] == "train"
    mode = (Look if train else modes.MODES[traffic["mode"]])(run)
    plant = (mock.patch.object(program, "trainer",
                               _replay_half(program.trainer)) if fault
             else contextlib.nullcontext())
    with plant:
        mode.setup()
    if not train:
        mode.window(seconds)
    mode.release()
    readings = mode.check()
    del mode
    modes.free(device)
    return readings


def serve_control(model, traffic, seed, device):
    weights = inputs.make_weights(modes.reference_shapes(model, False), seed,
                                  device)
    ref = modes.reference_nets(model, False, weights, device)
    del weights
    pool = inputs.make_batches(traffic, model, seed, device, train=False)
    picks = random.Random(seed).sample(range(len(pool)), traffic["sample"])
    got, want = [], []
    with torch.no_grad():
        for i in picks:
            want.append(R.quantize(R.inference(ref, pool[i])))
            with R.rounding(compare.fp8_round):
                got.append(R.quantize(R.inference(ref, pool[i])))
    return {"image_mad": compare.image_mad(got, want)}


def _train_run(model, batches, start, device, rounding=None, half_from=None):
    """(per-step losses, first gradient norms, the state after the second
    step, leaves after the third) of the reference from `start`; from step `half_from` on, each step takes the
    first half of its batch."""
    trainer = RT.Trainer(modes.reference_nets(model, True, start, device))
    losses = []
    with R.rounding(rounding):
        for j, batch in enumerate(batches):
            if half_from is not None and j >= half_from:
                batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            l, grads = trainer.step(batch)
            losses.append(l)
            if j == 0:
                norms = {k: float(g.norm()) for k, g in grads.items()}
            del grads
            if j == 1:
                mid = trainer.state()
    after = {k: v.detach().clone() for k, v in trainer.leaves().items()}
    return losses, norms, mid, after


def train_readings(model, traffic, seed, device, **how):
    """The compared numbers and the look of the reference put in the
    program's place (`how`: rounding, half_from) against the reference."""
    start = inputs.make_weights(modes.reference_shapes(model, True), seed,
                                device)
    batches = inputs.make_batches(traffic, model, seed, device,
                                  train=True)[:3]
    want, ref_grads, _, ref_after = _train_run(model, batches, start, device)
    got, got_grads, mid, got_after = _train_run(model, batches, start,
                                                device, **how)
    readings = compare.train_readings(got[0], want[0], got_after, ref_after,
                                      start, ref_grads)
    readings.update(look(got, want, got_grads, ref_grads))
    del ref_after
    follow = RT.Trainer(modes.reference_nets(model, True, mid["weights"],
                                             device))
    follow.resume(mid)
    losses, grads = follow.step(batches[2])
    readings.update(compare.replay_readings(
        got[2], losses, got_after, follow.leaves(), mid["weights"],
        {k: float(g.norm()) for k, g in grads.items()}))
    return readings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault_seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=ROOT)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    bench = manifest.Manifest(args.root)
    entry = bench.cell(args.workload)
    config = bench.config(entry["config"])
    traffic = bench.traffic(args.workload, entry)
    model = config["model"]
    device = torch.device(args.device)
    rows = []

    def emit(kind, seed, readings):
        row = {"kind": kind, "seed": seed, **readings}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        emit("program", seed, program_reading(entry, config, traffic, seed,
                                              args.seconds, device))
    train = traffic["mode"] == "train"
    for seed in args.fault_seeds if train else ():
        emit("replay_half", seed, program_reading(
            entry, config, traffic, seed, args.seconds, device, fault=True))
    for seed in args.control_seeds:
        if train:
            emit("control", seed, train_readings(
                model, traffic, seed, device, rounding=compare.fp8_round))
            emit("half_batch", seed, train_readings(
                model, traffic, seed, device, half_from=0))
        else:
            emit("control", seed, serve_control(model, traffic, seed,
                                                device))
        modes.free(device)
    summary = {}
    for kind in sorted({r["kind"] for r in rows}):
        pick = max if kind == "program" else min
        mine = [r for r in rows if r["kind"] == kind]
        summary[kind] = {k: pick(r[k] for r in mine) for k in mine[0]
                         if isinstance(mine[0][k], float)}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps({"workload": args.workload, **r}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
