"""Persistent inference server: the twin of tools/serve.py, flag for flag.
It watches an input directory for exemplar translation requests, runs them
through the same label preprocessing as the dataset pipelines, and writes
the results.

Deployment-shaped, continuous batching: the weights stay on the card, the
forward is captured once as a CUDA graph and replayed for every batch
(`make_serve_step`), and four pipeline stages overlap:

  watcher            polls --watch_dir for new request ids
  preprocess pool    --nThreads host workers run the dataset label
                     pipeline (PIL) concurrently
  dispatcher         packs whatever is ready into a fixed-size batch the
                     moment either the batch fills or --batch_window_ms
                     expires (tail slots padded), replays the graph and
                     queues the uint8 result's copy to pinned host memory;
                     up to 2 batches are in flight
  writer             waits on each batch's copy, writes the files and
                     records per-request END-TO-END latency (discovery to
                     file)

Usage, from the repository root:

  python -m cocosnet_tpu_torch.tools.serve --name ade20k \\
      --dataset_mode ade20k --checkpoints_dir ./checkpoints \\
      --watch_dir /path/in --out_dir /path/out [--batchSize 6]

Request layout per request id R (in --watch_dir):
  R.ref.jpg          exemplar photo (any PIL-readable format works)
  R.label.*          structural input for the label pipeline (below)
  R.ref_label.*      the same for the exemplar: REQUIRED, the
                     correspondence net consumes the exemplar's semantics
                     (pix2pix_model.py:308)
Output: <out_dir>/R.png|jpg|npy per --out_format (the uint8 quantization
runs on the card, so a batch comes back as uint8; npy skips image encoding),
or <out_dir>/R.error.txt on a bad request.

Label input formats, matching each dataset's get_label_tensor:
  ade20k / flickr    R.label.png: grayscale class-id mask
  celebahq           R.label.txt: one line, the all_parts_except_glasses
                       mask path (the pipeline finds the matching _eye_g
                       glasses mask itself, celebahq_dataset.py:67-84)
  celebahqedge       R.label.txt: one line, the mask-anno template path,
                       e.g. /data/CelebAMask-HQ/CelebAMask-HQ-mask-anno/0/00000_{}.png
                       (the pipeline opens <template>.format(part) per
                       facial part and the matching CelebA-HQ-img photo)
  deepfashion        R.label.txt: one line, the OpenPose template path,
                       e.g. /data/DeepFashion/pose/.../x_{}.txt
                       (formatted with candidate/subset; the matching img/
                       photo is derived from the path; rendering the pose
                       needs OpenCV)

Runs on the GPU; --platform cpu runs the same forward eagerly on the CPU
(the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import hashlib
import os
import queue
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from cocosnet_tpu_torch import pix2pix as P
from cocosnet_tpu_torch.cli import common
from cocosnet_tpu_torch.config import Options, parse_options
from cocosnet_tpu_torch.data import transforms as T
from cocosnet_tpu_torch.data.loader import dataset_registry
from cocosnet_tpu_torch.train import checkpoints as C
from cocosnet_tpu_torch.train.steps import make_inference_step
from cocosnet_tpu_torch.utils import profiling

# dataset modes whose labels are plain class-id PNG masks
_MASK_MODES = ("ade20k", "flickr")
# modes whose label pipeline resolves a path (template) to the raw assets
_PATH_MODES = ("celebahq", "celebahqedge", "deepfashion")
# the label channels each mode's pipeline makes (tools/serve.py:152-154)
LABEL_CHANNELS = {"ade20k": 1, "flickr": 1, "celebahq": 2,
                  "celebahqedge": 15, "deepfashion": 20}


def input_channels(opt: Options) -> Dict[str, int]:
    """The entries of the batch a step takes, and the channels of each."""
    lc = LABEL_CHANNELS[opt.dataset_mode]
    return {"label": lc, "image": 3, "ref": 3, "label_ref": lc}


def make_label_pipeline(opt: Options):
    """A dataset object of opt.dataset_mode that has not walked a dataroot:
    its label_params / get_label_tensor need only opt and the seeded
    generator, and preprocessing must match data/*.py exactly or the
    model sees out-of-distribution inputs."""
    cls = dataset_registry()[opt.dataset_mode]
    ds = cls.__new__(cls)
    ds.opt = opt
    ds.rng = random.Random(opt.seed)
    return ds


def label_tensor(pipeline, path: str) -> Tuple[np.ndarray, Dict]:
    """(HWC float32 label array, its transform params): the JAX pipeline's
    one-call get_label_tensor (pix2pix_dataset.py:99-107) from the port's
    label_params + get_label_tensor(path, params)."""
    params = pipeline.label_params(path)
    return pipeline.get_label_tensor(path, params), params


def resolve_label_input(opt: Options, watch_dir: str, req: str) -> str:
    """-> the path (template) of `req` to feed the label pipeline: the
    mask R.png, or the one line of R.txt in the path-template modes;
    raises ValueError."""
    if opt.dataset_mode in _MASK_MODES:
        p = os.path.join(watch_dir, req + ".png")
        if not os.path.exists(p):
            raise ValueError(f"missing {p}")
        return p
    p = os.path.join(watch_dir, req + ".txt")
    if not os.path.exists(p):
        raise ValueError(f"missing {p} (path-template request file)")
    with open(p) as f:
        template = f.read().strip()
    if not template:
        raise ValueError(f"{p} is empty")
    return template


def zero_batch(opt: Options, batch_size: int) -> Dict[str, np.ndarray]:
    """The step's input batch, all zeros: (B, crop, crop, C) per entry and
    self_ref (B,), float32 (tools/serve.py:160-167)."""
    h = opt.crop_size
    batch = {k: np.zeros((batch_size, h, h, c), np.float32)
             for k, c in input_channels(opt).items()}
    batch["self_ref"] = np.zeros((batch_size,), np.float32)
    return batch


def quantize(y: torch.Tensor) -> torch.Tensor:
    """serve.py's uint8 quantization of an image in [-1, 1]
    (tools/serve.py:184-187): rounds half up. utils/visuals.tensor2im
    truncates instead, one level below on about half the pixels."""
    return torch.clamp(torch.floor((y.float() + 1.0) * 127.5 + 0.5),
                       0.0, 255.0).to(torch.uint8)


class GraphStep:
    """`forward` captured once as a CUDA graph for its fixed input shapes
    (one batch size, one crop), replayed from static input buffers.

    `warm_up` runs the forward eagerly on the static inputs on the capture
    stream: the kernels' libraries build and load at first use, the
    wrappers look up the card, cuBLAS makes its handle. `capture` records
    one forward; a call copies a batch into the static inputs and replays
    it (capturing first if needed), on the current stream. The result is
    the graph's own output buffer, which the next call overwrites: copy it
    out on the current stream before calling again. A capture or replay
    that fails raises; nothing falls back to the eager forward.

    A call records two host spans (utils/profiling.span), both with the
    call's sequence number as their id: `serve.copy_in`, the copies of the
    inputs (each pinned anew), then `serve.launch`, the replay's launch."""

    def __init__(self, forward: Callable, inputs: Dict[str, torch.Tensor]):
        self.forward = forward
        self.inputs = inputs
        self.stream = torch.cuda.Stream(next(iter(inputs.values())).device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.output: Optional[torch.Tensor] = None
        self.calls = 0

    def warm_up(self) -> None:
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            for _ in range(2):
                self.forward(self.inputs)
        current.wait_stream(self.stream)

    def capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            output = self.forward(self.inputs)
        self.graph, self.output = graph, output

    def __call__(self, batch) -> torch.Tensor:
        if self.graph is None:
            self.warm_up()
            self.capture()
        self.calls += 1
        with profiling.span("serve.copy_in", self.calls):
            for k, dst in self.inputs.items():
                src = torch.as_tensor(batch[k], dtype=torch.float32)
                if src.shape != dst.shape:
                    raise ValueError(f"{k}: the graph takes "
                                     f"{tuple(dst.shape)}, got "
                                     f"{tuple(src.shape)}")
                if not src.is_cuda:
                    # a pinned copy of its own each call: the host
                    # allocator keeps it until this copy has run
                    src = src.pin_memory()
                dst.copy_(src, non_blocking=True)
        with profiling.span("serve.launch", self.calls):
            self.graph.replay()
        return self.output


def make_serve_step(nets: P.Pix2PixNets, batch_size: int):
    """step(batch) -> (B, H, W, 3) uint8 on the nets' device: the inference
    forward (train/steps.make_inference_step) followed by serve.py's
    quantization. batch: the entries of zero_batch, numpy arrays or
    tensors. On the card the forward is a GraphStep for (batch_size,
    crop); on the CPU it runs eagerly, returning a fresh tensor each
    call. The forward marks its stages (utils/profiling.mark): `prep`
    first, `corr` and `gen` in pix2pix.generate_fake, `end` after the
    quantization."""
    infer = make_inference_step(nets)

    def forward(batch) -> torch.Tensor:
        with torch.inference_mode():
            profiling.mark("prep", nets.device)
            out = quantize(infer(batch)["fake_image"])
            profiling.mark("end", nets.device)
            return out

    if nets.device.type != "cuda":
        return forward
    inputs = {k: torch.from_numpy(v).to(nets.device)
              for k, v in zero_batch(nets.opt, batch_size).items()}
    return GraphStep(forward, inputs)


def to_host(out: torch.Tensor):
    """(host tensor, event): a card result copied into pinned host memory
    of its own on the current stream, and the event that marks the copy
    done; a CPU result as it is, with no event."""
    if not out.is_cuda:
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


@dataclasses.dataclass
class ServeRun:
    """What a run did: requests served and failed, each served request's
    end-to-end latency (discovery to file, host clock, ms), and the
    request ids of each dispatched batch, slot by slot (padding left
    out)."""
    served: int = 0
    failed: int = 0
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    batches: List[List[str]] = dataclasses.field(default_factory=list)


def parse_args(argv=None):
    """(server flags, model Options): serve.py's flags, the rest through
    the port's parse_options for the test phase."""
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--watch_dir", required=True)
    extra.add_argument("--out_dir", required=True)
    extra.add_argument("--poll_s", type=float, default=0.5)
    extra.add_argument("--once", action="store_true",
                       help="serve pending requests then exit (for tests)")
    extra.add_argument("--batch_window_ms", type=float, default=25.0,
                       help="max time the dispatcher waits to fill a batch "
                            "once at least one request is ready")
    extra.add_argument("--out_format", choices=("png", "jpg", "npy"),
                       default="png",
                       help="result encoding: png (lossless), jpg (fast, "
                            "lossy, quality 92), npy (raw uint8 HWC)")
    extra.add_argument("--png_level", type=int, default=1,
                       help="zlib level for png results (lossless at every "
                            "level; 1 encodes ~4x faster than PIL's 6)")
    extra.add_argument("--preprocess_cache", type=int, default=256,
                       help="entries in the content-hash decode/preprocess "
                            "cache (repeated exemplars/labels skip PIL + "
                            "transforms); 0 disables")
    args, rest = extra.parse_known_args(argv)
    return args, parse_options(rest, is_train=False)


def load_nets(opt: Options, device) -> P.Pix2PixNets:
    """G and Corr with their checkpoint (checkpoints.load_inference's
    order); raises SystemExit where there is none, unless
    --allow_random_weights."""
    nets = P.Pix2PixNets(opt, device=device, seed=opt.seed)
    ckpt_dir = os.path.join(opt.checkpoints_dir, opt.name)
    loaded = C.load_inference(opt, nets, opt.which_epoch)
    if loaded is not None:
        print(loaded, flush=True)
    elif opt.allow_random_weights:
        print(f"WARNING: no checkpoint under {ckpt_dir}; serving RANDOM "
              "weights (--allow_random_weights)", flush=True)
    else:
        raise SystemExit(f"No checkpoint found under {ckpt_dir}; refusing to "
                         "serve random weights (--allow_random_weights to "
                         "override)")
    return nets


def main(argv=None) -> ServeRun:
    args, opt = parse_args(argv)
    if opt.dataset_mode not in _MASK_MODES + _PATH_MODES:
        raise SystemExit(f"serve cannot preprocess labels for "
                         f"--dataset_mode {opt.dataset_mode}")
    device = common.device_for(opt.platform)
    common.set_numerics(opt)
    nets = load_nets(opt, device)
    pipeline = make_label_pipeline(opt)
    h, b = opt.crop_size, opt.batchSize
    step = make_serve_step(nets, b)
    zeros = zero_batch(opt, b)
    step(zeros)  # capture once up front
    os.makedirs(args.out_dir, exist_ok=True)
    how = ("as a resident CUDA graph" if device.type == "cuda"
           else "eagerly on the CPU")
    print(f"serving {opt.dataset_mode} from {args.watch_dir} (batch {b}, "
          f"{h}px, {zeros['label'].shape[-1]}ch labels) {how}", flush=True)

    # Content-hash decode/preprocess cache: exemplar serving reuses a
    # catalogue of reference photos and labels, and the host decode and
    # transforms are the server's own cost. Keyed by file CONTENT
    # (requests arrive as per-id copies, so path + mtime would never hit).
    cache_n = args.preprocess_cache
    pre_cache: "collections.OrderedDict" = collections.OrderedDict()
    cache_lock = threading.Lock()

    def content_key(kind, path_or_template, salt):
        if os.path.exists(path_or_template):
            with open(path_or_template, "rb") as f:
                return (kind, hashlib.md5(f.read()).hexdigest(), salt)
        # a path-template request names static dataset assets: the string
        # identifies them
        return (kind, path_or_template, salt)

    def cached(kind, path, fn, salt=""):
        if not cache_n:
            return fn()
        key = content_key(kind, path, salt)
        with cache_lock:
            if key in pre_cache:
                pre_cache.move_to_end(key)
                return pre_cache[key]
        val = fn()
        with cache_lock:
            pre_cache[key] = val
            while len(pre_cache) > cache_n:
                pre_cache.popitem(last=False)
        return val

    def load_request(req):
        """-> item dict (label/ref/label_ref) via the dataset pipeline."""
        label_in = resolve_label_input(opt, args.watch_dir, req + ".label")
        ref_label_in = resolve_label_input(opt, args.watch_dir,
                                           req + ".ref_label")
        ref_path = os.path.join(args.watch_dir, req + ".ref.jpg")
        if not os.path.exists(ref_path):
            raise ValueError(f"missing {ref_path}")
        label, _ = cached("label", label_in,
                          lambda: label_tensor(pipeline, label_in))
        ref_label, ref_params = cached(
            "label", ref_label_in,
            lambda: label_tensor(pipeline, ref_label_in))
        # the ref transform takes its params from the ref_label pipeline,
        # so the cache key carries them
        psalt = repr(sorted(ref_params.items()))
        ref = cached(
            "ref", ref_path,
            lambda: T.image_to_tensor(
                opt, Image.open(ref_path).convert("RGB"), ref_params),
            salt=psalt)
        item = {"label": label, "ref": ref, "label_ref": ref_label}
        for k, v in item.items():
            if v.shape != zeros[k].shape[1:]:
                raise ValueError(f"the pipeline made {k} {v.shape}, the "
                                 f"step takes {zeros[k].shape[1:]}")
        return item

    run = ServeRun()
    seen = set()                       # touched only by the watcher side
    pre_q: "queue.Queue" = queue.Queue()
    ready_q: "queue.Queue" = queue.Queue(maxsize=max(4 * b, 8))
    write_q: "queue.Queue" = queue.Queue(maxsize=2)  # <=2 batches in flight
    stop = threading.Event()
    lock = threading.Lock()            # run's counts and inflight
    inflight = [0]                     # discovered, not yet written/errored

    def scan_once():
        new = sorted(
            f[: -len(".ref.jpg")] for f in os.listdir(args.watch_dir)
            if f.endswith(".ref.jpg") and f[: -len(".ref.jpg")] not in seen)
        t = time.perf_counter()
        for r in new:
            seen.add(r)
            with lock:
                inflight[0] += 1
            pre_q.put((r, t))

    def fail(r, msg):
        with open(os.path.join(args.out_dir, r + ".error.txt"), "w") as f:
            f.write(msg + "\n")
        with lock:
            inflight[0] -= 1
            run.failed += 1

    def preprocessor():
        while not stop.is_set():
            try:
                r, t_disc = pre_q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                item = load_request(r)
            except Exception as e:  # noqa: BLE001 - a bad request must
                # never kill the worker thread: record it and move on
                fail(r, f"{type(e).__name__}: {e}")
                continue
            ready_q.put((r, item, t_disc))

    def save_result(img_u8, path_noext):
        if args.out_format == "npy":
            np.save(path_noext + ".npy", img_u8)
        elif args.out_format == "jpg":
            Image.fromarray(img_u8).save(path_noext + ".jpg", quality=92)
        else:
            Image.fromarray(img_u8).save(path_noext + ".png",
                                         compress_level=args.png_level)

    def writer():
        while True:
            got = write_q.get()
            if got is None:
                return
            (host, done), metas = got
            try:
                if done is not None:
                    done.synchronize()         # this batch's copy
                out = host.numpy()
            except Exception as e:  # noqa: BLE001 - a device-side failure
                for _, r, _ in metas:
                    fail(r, f"device error: {type(e).__name__}: {e}")
                continue
            t_done = time.perf_counter()
            lats = []
            for j, r, t_disc in metas:
                try:
                    save_result(out[j], os.path.join(args.out_dir, r))
                except Exception as e:  # noqa: BLE001 - e.g. disk full
                    fail(r, f"write error: {type(e).__name__}: {e}")
                    continue
                lats.append((t_done - t_disc) * 1000.0)
                with lock:
                    inflight[0] -= 1
            if not lats:
                continue
            with lock:
                run.latencies_ms.extend(lats)
                run.served += len(lats)
                p50 = float(np.percentile(run.latencies_ms, 50))
                p99 = float(np.percentile(run.latencies_ms, 99))
                total = run.served
            print(f"served {len(lats)} requests ({total} total); e2e "
                  f"latency p50 {p50:.1f} ms p99 {p99:.1f} ms", flush=True)

    workers = [threading.Thread(target=preprocessor, daemon=True)
               for _ in range(max(1, opt.nThreads))]
    wr = threading.Thread(target=writer, daemon=True)
    for t in workers + [wr]:
        t.start()

    window = args.batch_window_ms / 1000.0
    try:
        last_scan = 0.0
        while True:
            if last_scan == 0.0 \
                    or time.perf_counter() - last_scan >= args.poll_s:
                scan_once()
                last_scan = time.perf_counter()
            if args.once:
                with lock:
                    if inflight[0] == 0 and pre_q.empty() \
                            and ready_q.empty():
                        break
            # continuous batching: block for the first ready item, then
            # top up until the batch fills or the window expires. The idle
            # block is capped by --poll_s so discovery latency honors it.
            try:
                first = ready_q.get(timeout=max(0.01, min(0.2, args.poll_s)))
            except queue.Empty:
                continue
            metas = [first]
            deadline = time.perf_counter() + window
            while len(metas) < b:
                tleft = deadline - time.perf_counter()
                if tleft <= 0 and not args.once:
                    break
                try:
                    metas.append(ready_q.get(
                        timeout=0.05 if args.once else max(tleft, 0.01)))
                except queue.Empty:
                    if args.once:
                        break
            batch = {k: v.copy() for k, v in zeros.items()}
            slot_meta = []
            for j, (r, item, t_disc) in enumerate(metas):
                for k, v in item.items():
                    batch[k][j] = v
                slot_meta.append((j, r, t_disc))
            run.batches.append([r for _, r, _ in slot_meta])
            # the replay and the copy of its result are queued on the
            # stream; the writer waits for the copy, so the next batch's
            # preprocessing and dispatch overlap this one's compute
            write_q.put((to_host(step(batch)), slot_meta))
    finally:
        stop.set()
        write_q.put(None)
        wr.join(timeout=30)
        for t in workers:
            t.join(timeout=5)
    return run


if __name__ == "__main__":
    main()
