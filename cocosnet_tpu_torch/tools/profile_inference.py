"""Stage-by-stage time, FLOPs and device time by kernel family of the
flagship inference path (ade20k, 256 px, match_kernel 3, batch 6, bf16
policy by default, seeded random weights at unit signal scale). Twin of
tools/profile_inference.py, with its stages, names and order:

  preprocess_input                 the one-hot scatter
  correspondence total             both adaptors, the residual stack,
                                   theta / phi, the correlation and warp (the
                                   seg adaptor's first conv on the labels,
                                   conv3x3_onehot.cu, as in the full forward)
  generator total                  the SPADE generator
  full inference                   pix2pix.inference
  adaptor (seg, 151ch)             the seg adaptor on the dense one-hot
  adaptor (seg, gather-onehot)     the same on the labels (conv3x3_onehot.cu)
  adaptor (img, 3ch)               the exemplar's adaptor
  residual stack (4x407ch)         the four blocks on conv3x3.cu's statistics
                                   path
  descriptor unfold+norm (1 side)  the 3x3 unfold, centring, normalisation
  correlation attend (C=2304)      attend_chunked on the unfolded
                                   descriptors (the library route)
  attend_shift9 (fused kernel)     csrc/shift9_fwd.cu on raw features

Per stage: ms (CUDA events, the median of --iters after warm-ups), GFLOP
(torch.utils.flop_counter for library ops, plus each hand-written kernel's
operation count from utils/profiling, which the counter cannot see), the
share of the full forward and of --peak_tflops, and from one profiled call
the device-busy ms and the device time and launches by kernel family, the
elementwise family among them; a stage whose profile misses a launch of a
hand-written kernel raises. The JAX tool's dispatch-overhead subtraction and
k-fold scan timer answer its TPU link and are not ported. Writes a markdown
table to --out (never PROFILE.md, the JAX tool's); --trace_dir writes a
torch.profiler Chrome trace of one full forward.

    python -m cocosnet_tpu_torch.tools.profile_inference [--batch 6] \\
        [--iters 20] [--platform cpu --crop_size 64 --ngf 8]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List

import numpy as np
import torch

from cocosnet_tpu_torch.utils import profiling as PR

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "build", "profiles", "profile_inference.md")
STAGES = ("preprocess_input", "correspondence total", "generator total",
          "full inference", "  adaptor (seg, 151ch)",
          "  adaptor (seg, gather-onehot)", "  adaptor (img, 3ch)",
          "  residual stack (4x407ch)", "  descriptor unfold+norm (1 side)",
          "  correlation attend (C=2304)", "  attend_shift9 (fused kernel)")


def flagship_opt(batch: int, crop_size: int = 256, ngf: int = 64,
                 **kw):
    """The port's copy of bench._opt (the reference README's ade20k flags,
    match_kernel 3) at `batch`."""
    from cocosnet_tpu_torch.config import test_defaults
    return test_defaults(**{**dict(
        dataset_mode="ade20k", label_nc=150, contain_dontcare_label=True,
        crop_size=crop_size, load_size=crop_size, batchSize=batch, ngf=ngf,
        use_attention=True, maskmix=True, PONO=True, PONO_C=True,
        warp_mask_losstype="direct", match_kernel=3,
        vgg_normal_correct=True, isTrain=False), **kw})


def flagship_batch(opt, batch: int):
    """The port's copy of bench._batch: labels, photo and exemplar from
    RandomState(0)."""
    rs = np.random.RandomState(0)
    h = opt.crop_size
    return {
        "label": rs.randint(0, opt.semantic_nc,
                            (batch, h, h, 1)).astype(np.float32),
        "image": (rs.rand(batch, h, h, 3).astype(np.float32) * 2 - 1),
        "ref": (rs.rand(batch, h, h, 3).astype(np.float32) * 2 - 1),
        "label_ref": rs.randint(0, opt.semantic_nc,
                                (batch, h, h, 1)).astype(np.float32),
        "self_ref": np.ones((batch,), np.float32),
    }


def stage_fns(opt, nets, batch, device):
    """(name, fn) per stage, in STAGES's order, each fn one call of the
    stage without gradients."""
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.nn.layers import OneHotLabels
    from cocosnet_tpu_torch.ops.correlation import attend_chunked
    from cocosnet_tpu_torch.ops.shift9 import attend_shift9
    from cocosnet_tpu_torch.tools.bench_corr import descriptor
    data = P.preprocess_input(opt, batch, device=device)
    corr = nets.corr
    sem, label, ref = (data["input_semantics"], data["input_label"],
                       data["ref_image"])

    def correspondence():
        return corr(ref, sem, data["ref_semantics"], seg_label=label)

    with torch.no_grad():
        cbn = P.cbn_input(opt, correspondence()["warp_out"], sem)
    b, h = opt.batchSize, opt.crop_size // opt.down
    ch = corr.layer[0].conv1.weight.shape[0]
    rs = np.random.RandomState(1)

    def draw(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
            device)

    feat = draw(b, h, h, ch)
    n = h * h
    q, k, v154 = draw(b, n, 2304), draw(b, n, 2304), draw(b, n, 154)
    fraw, graw = draw(b, h, h, 256), draw(b, h, h, 256)
    fns = [
        lambda: P.preprocess_input(opt, batch, device=device),
        correspondence,
        lambda: nets.gen(sem, cbn),
        lambda: P.inference(nets, data)["fake_image"],
        lambda: corr.adaptive_model_seg(sem, sem),
        lambda: corr.adaptive_model_seg(
            OneHotLabels(label, opt.semantic_nc, sem.dtype), sem),
        lambda: corr.adaptive_model_img(ref, ref),
        lambda: corr.layer(feat),
        lambda: descriptor(feat[..., :256]),
        lambda: attend_chunked(q, k, v154, 0.01),
        lambda: attend_shift9(fraw, graw, v154, 0.01, True),
    ]
    names = list(STAGES)
    names[7] = f"  residual stack (4x{ch}ch)"
    names[4] = f"  adaptor (seg, {opt.semantic_nc}ch)"

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    return [(nm, no_grad(fn)) for nm, fn in zip(names, fns)]


def run(args) -> List[dict]:
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.cli.common import device_for
    from cocosnet_tpu_torch.nn import layers as L
    from cocosnet_tpu_torch.nn.layers import condition_weights
    t0 = time.perf_counter()
    device = device_for(args.platform)
    cuda = device.type == "cuda"
    print(PR.card_line(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    policy = L.get_compute_dtype()
    L.set_compute_dtype(torch.bfloat16 if args.compute_dtype == "bf16"
                        else None)
    try:
        opt = flagship_opt(args.batch, args.crop_size, args.ngf,
                           compute_dtype=args.compute_dtype)
        nets = P.Pix2PixNets(opt, device=device, seed=0)
        g = torch.Generator().manual_seed(0)
        condition_weights(nets.corr, g, device)
        condition_weights(nets.gen, g, device)
        batch = flagship_batch(opt, args.batch)
        print(f"set-up took {time.perf_counter() - t0:.1f} s", flush=True)
        rows = []
        for name, fn in stage_fns(opt, nets, batch, device):
            rows.append(PR.measure_stage(name, fn, args.iters, cuda))
            PR.print_stage(rows[-1], args.peak_tflops)
        if args.trace_dir:
            data = P.preprocess_input(opt, batch, device=device)
            with PR.maybe_trace(args.trace_dir, name="full_inference"):
                P.inference(nets, data)
    finally:
        L.set_compute_dtype(policy)
    full = next(r for r in rows if r["name"] == "full inference")
    print(f"images/s at this timing: {args.batch / (full['ms'] / 1e3):.2f}",
          flush=True)
    table = PR.stage_table(
        rows, "full inference", args.peak_tflops,
        f"# Inference profile: ade20k, {args.crop_size} px, batch "
        f"{args.batch}, ngf {args.ngf}, {args.compute_dtype} policy "
        f"({PR.card_line()})")
    print(table, flush=True)
    if args.out:
        PR.write_report(args.out, table)
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--peak_tflops", type=float,
                    default=PR.BF16_FLOP_S / 1e12,
                    help="the card's dense bf16 peak (H100 SXM: 989)")
    ap.add_argument("--trace_dir", default="",
                    help="also write a torch.profiler trace of one full "
                         "forward here")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the markdown table ('' writes none)")
    ap.add_argument("--platform", default="",
                    help="'' or gpu: the card (raises without one); cpu: "
                         "the plain versions")
    ap.add_argument("--crop_size", type=int, default=256)
    ap.add_argument("--ngf", type=int, default=64)
    ap.add_argument("--compute_dtype", default="bf16", choices=("bf16", "f32"))
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
