"""The three ways a cell drives the port, chosen by its traffic file's
`mode`:

- "serve": a closed loop of fixed batches through the serve graph, driven
  as tools/serve.py's dispatcher drives it: `to_host(step(batch))`, the
  next batch dispatched before the last result is waited on. A batch's
  images count once their uint8 result is in host memory.
- "request": one client, one request at a time through a batch-1 serve
  graph: a request runs from handing its arrays to the step until its
  result is in host memory.
- "train": chunks of `chunk` steps through make_multi_train_step, one host
  read of the chunk's losses each. Its first three steps run in set-up
  through the same call, a step at a time (the chunk's two eager warm-up
  steps, then its capture and first replay), with the run's state copied
  to the host before the third: the reference follows the three from the
  start and takes the third from that state.

Each mode sets itself up from the seed, runs the window, runs a traced
segment of the same work, counts its model FLOPs on the reference, frees
the program and judges what the program produced against the plain
reference.
"""

from __future__ import annotations

import gc
import math
import random
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from benchmark import compare, counts, inputs, program, trace
from benchmark.reference import model as R
from benchmark.reference import train as RT


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def reference_shapes(model: dict, train: bool) -> Dict[str, tuple]:
    with torch.device("meta"):
        nets = R.Nets(model, train)
    return {k: tuple(v.shape) for k, v in nets.state_dict().items()}


def reference_nets(model: dict, train: bool, weights, device) -> R.Nets:
    """The reference's nets holding `weights`, in float32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        nets = R.Nets(model, train)
    nets.to_empty(device=device)
    nets.load_state_dict(weights)
    return nets


def meta_batch(model: dict, b: int) -> Dict[str, torch.Tensor]:
    h = model["crop_size"]
    lc = 1 if model["label_mode"] == "ids" else model["semantic_nc"]
    with torch.device("meta"):
        return {"label": torch.zeros(b, h, h, lc),
                "image": torch.zeros(b, h, h, 3),
                "ref": torch.zeros(b, h, h, 3),
                "label_ref": torch.zeros(b, h, h, lc),
                "self_ref": torch.ones(b)}


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile."""
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1,
                       max(0, math.ceil(q / 100 * len(ordered)) - 1))]


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Mode:
    train = False

    def __init__(self, run):
        self.run = run
        self.model = run.config["model"]
        self.traffic = run.traffic
        self.device = run.device
        self.b = self.traffic["batch"]

    def weights(self):
        return inputs.make_weights(
            reference_shapes(self.model, self.train), self.run.seed,
            self.device)


class Serve(Mode):
    """The "serve" and "request" modes."""

    def setup(self) -> None:
        run, b = self.run, self.b
        opt = program.options(run.config, False, b)
        program.set_numerics(opt)
        self.nets = program.build_nets(opt, self.device, self.weights())
        free(self.device)
        pool = inputs.make_batches(self.traffic, self.model, run.seed,
                                   self.device, train=False)
        # the dispatcher hands the step host arrays
        self.pool = [{k: v.cpu().numpy() for k, v in x.items()}
                     for x in pool]
        del pool
        self.step = program.serve_step(self.nets, b)
        with counts.counted_calls() as tally:
            if self.device.type == "cuda":
                self.step.warm_up()          # two eager forwards
                forwards = 2
            else:
                self.step(self.pool[0])
                forwards = 1
        run.counts = {k: {f: v / forwards for f, v in rec.items()}
                      for k, rec in tally.items()}
        if self.device.type == "cuda":
            self.step.capture()
        for x in self.pool[:2]:
            self._wait(program.to_host(self.step(x)))
        self.rng = random.Random(run.seed)
        self.kept: List = []          # (pool index, uint8 host batch)
        self.seen = 0

    @staticmethod
    def _wait(result):
        host, done = result
        if done is not None:
            done.synchronize()
        return host

    def _keep(self, index: int, host) -> None:
        """Reservoir sample of the finished batches, drawn from the seed."""
        k = self.traffic["sample"]
        self.seen += 1
        if len(self.kept) < k:
            self.kept.append((index, host))
        else:
            j = self.rng.randrange(self.seen)
            if j < k:
                self.kept[j] = (index, host)

    def flops(self) -> float:
        """Model FLOPs of one forward, on the reference at the meta
        device."""
        with torch.device("meta"):
            nets = R.Nets(self.model, False)
        return counts.model_flops(
            lambda: R.inference(nets, meta_batch(self.model, self.b)))

    def window(self, seconds: float) -> dict:
        if self.traffic["mode"] == "request":
            return self._requests(seconds)
        return self._batches(seconds)

    def _batches(self, seconds: float, keep: bool = True,
                 units: int = 0) -> dict:
        n = len(self.pool)
        done = dispatched = 0
        pending = None
        t0 = time.perf_counter()
        end = t0 + seconds
        while (time.perf_counter() < end if not units
               else dispatched < units):
            i = dispatched % n
            with record_function("serve.dispatch"):
                result = program.to_host(self.step(self.pool[i]))
            dispatched += 1
            if pending is not None:
                with record_function("serve.wait"):
                    host = self._wait(pending[1])
                done += self.b
                if keep:
                    self._keep(pending[0], host)
            pending = (i, result)
        with record_function("serve.wait"):
            host = self._wait(pending[1])
        done += self.b
        if keep:
            self._keep(pending[0], host)
        elapsed = time.perf_counter() - t0
        return {"attempted": dispatched * self.b, "failed": 0,
                "units": dispatched, "seconds": elapsed,
                "infer_images_per_s": done / elapsed}

    def _requests(self, seconds: float, keep: bool = True,
                  units: int = 0) -> dict:
        n = len(self.pool)
        lat = []
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end if not units else len(lat) < units:
            i = len(lat) % n
            t = time.perf_counter()
            with record_function("request"):
                host = self._wait(program.to_host(self.step(self.pool[i])))
            lat.append(time.perf_counter() - t)
            if keep:
                self._keep(i, host)
        elapsed = time.perf_counter() - t0
        if keep:
            self.run.requests = lat
        return {"attempted": len(lat), "failed": 0, "units": len(lat),
                "seconds": elapsed,
                "request_p95_ms": 1e3 * percentile(lat, 95)}

    def traced(self, units: int) -> trace.Trace:
        with trace.traced(units) as rec:
            if self.traffic["mode"] == "request":
                self._requests(0, keep=False, units=units)
            else:
                self._batches(0, keep=False, units=units)
        return rec

    def release(self) -> None:
        del self.step, self.nets
        free(self.device)

    def check(self) -> Dict[str, float]:
        weights = self.weights()
        ref = reference_nets(self.model, False, weights, self.device)
        del weights
        want, got, cache = [], [], {}
        with torch.no_grad():
            for index, host in self.kept:
                if index not in cache:
                    x = {k: torch.from_numpy(v).to(self.device)
                         for k, v in self.pool[index].items()}
                    cache[index] = R.quantize(R.inference(ref, x)).cpu()
                want.append(cache[index])
                got.append(host)
        return {"image_mad": compare.image_mad(got, want)}


class Train(Mode):
    train = True

    def setup(self) -> None:
        run, b = self.run, self.b
        opt = program.options(run.config, True, b)
        program.set_numerics(opt)
        self.nets = program.build_nets(opt, self.device, self.weights())
        free(self.device)
        pool = inputs.make_batches(self.traffic, self.model, run.seed,
                                   self.device, train=True)
        cuda = self.device.type == "cuda"
        self.pool = [{k: (v.cpu().pin_memory() if cuda else v.cpu())
                      for k, v in x.items()} for x in pool]
        del pool
        self.state, self.multi, self.lr = program.trainer(opt, self.nets)
        with counts.counted_calls() as tally:
            self.losses = self._steps(self.pool[:1])
        run.counts = tally
        self.first_step()
        self.losses += self._steps(self.pool[1:2])
        self.mid = program.snapshot(self.state, self.nets)
        self.losses += self._steps(self.pool[2:3])
        self.after = self._leaves()
        self.next = 3

    def _steps(self, batches) -> List[Dict[str, float]]:
        """Steps through the window's own call: each step's losses."""
        losses, _ = self.multi(self.state, batches, self.lr)
        return [{k: float(v[j]) for k, v in losses.items()}
                for j in range(len(batches))]

    def _leaves(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().to("cpu", copy=True) for k, v in
                program.trained_leaves(self.state, self.nets).items()}

    def first_step(self) -> None:
        """Called after the run's first step (benchmark/calibrate.py reads
        the gradients the optimizers got here)."""

    def flops(self) -> float:
        """Model FLOPs of one train step's forward and backward work, on
        the reference at the meta device."""
        with torch.device("meta"):
            nets = R.Nets(self.model, True)
        g_params = list(nets.gen.parameters()) + list(nets.corr.parameters())
        return counts.model_flops(lambda: RT.step_work(
            nets, meta_batch(self.model, self.b), g_params,
            list(nets.disc.parameters())))

    def _chunks(self, seconds: float, units: int = 0) -> dict:
        k, n = self.traffic["chunk"], len(self.pool)
        steps = bad = 0
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end if not units else steps < units:
            batches = [self.pool[(self.next + j) % n] for j in range(k)]
            self.next += k
            with record_function("train.chunk"):
                losses, _ = self.multi(self.state, batches, self.lr)
            with record_function("train.read_losses"):
                rows = torch.stack(list(losses.values())).cpu()
            steps += k
            bad += int((~torch.isfinite(rows)).any(0).sum())
        elapsed = time.perf_counter() - t0
        return {"attempted": steps, "failed": bad, "units": steps,
                "seconds": elapsed,
                "train_images_per_s": steps * self.b / elapsed}

    def window(self, seconds: float) -> dict:
        return self._chunks(seconds)

    def traced(self, units: int) -> trace.Trace:
        with trace.traced(units) as rec:
            self._chunks(0, units=units)
        return rec

    def release(self) -> None:
        del self.multi, self.state, self.nets
        free(self.device)

    def check(self) -> Dict[str, float]:
        """The reference's three steps from the seeded weights (the first
        step's losses, the change after three), then its third step from
        the program's own state before it (the first replayed step: by then
        the two sides' runs have parted by the sign-like first Adam steps
        of leaves whose gradient sits at rounding level)."""
        dev = self.device
        start = self.weights()
        ref = RT.Trainer(reference_nets(self.model, True, start, dev))
        want = []
        for j in range(3):
            losses, grads = ref.step(self._batch(j))
            want.append(losses)
            if j == 0:
                ref_grads = {k: float(g.norm()) for k, g in grads.items()}
            del grads
        readings = compare.train_readings(self.losses[0], want[0],
                                          self.after, ref.leaves(), start,
                                          ref_grads)
        self.independent = (want, ref_grads)
        del ref, start
        free(dev)
        mid = to_device(self.mid, dev)
        follow = RT.Trainer(reference_nets(self.model, True, mid["weights"],
                                           dev))
        follow.resume(mid)
        losses, grads = follow.step(self._batch(2))
        grads = {k: float(g.norm()) for k, g in grads.items()}
        readings.update(compare.replay_readings(
            self.losses[2], losses, self.after, follow.leaves(),
            mid["weights"], grads))
        return readings

    def _batch(self, j: int) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device) for k, v in self.pool[j].items()}


def to_device(tree, device):
    """A snapshot's tensors (in dicts and tuples) on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_device(v, device) for v in tree)
    return tree


MODES = {"serve": Serve, "request": Serve, "train": Train}
