"""Segment-by-segment time, FLOPs and device time by kernel family of the
flagship train step (ade20k, 256 px, match_kernel 3, batch 8, EMA,
weight_mask 100, bf16 policy, seeded random weights at unit signal scale).
Twin of tools/profile_train.py, with its ten segments:

  preprocess               the one-hot scatter
  G fwd (losses)           generate_fake + the VGG19 towers + every G loss
                           term, forward only
  D fwd (losses)           discriminate(fake, real) + the hinge losses,
                           forward only
  G adam / D adam          the optimizer step alone, on zero gradients
  EMA update               the shadows of netG + netCorr
  one VGG19 tower          (the G phase runs three)
  G phase (bwd+adam+EMA)   train/steps.make_g_step: the train step's
                           generator half
  D phase (bwd+adam)       train/steps.make_d_step on the G forward's fake
  full train_step          train/steps.make_train_step

Each segment is measured as profile_inference's stages are: ms by CUDA
events (the median of --iters after warm-ups), GFLOP (the FLOP counter plus
the hand-written kernels' counts), the share of the full step and of
--peak_tflops, and one profiled call's device time by kernel family, the
elementwise family among them; a segment whose profile misses a launch of
a hand-written kernel raises. The stateful segments update the weights,
optimizer states and shadows they time. The JAX tool runs its donated
chained segments in child processes (--segment): the memory discipline of
a 16 GB TPU v5e. On the 80 GB card the segments run in one process, so that
flag, and the k-fold scan timer, are not ported. Writes a markdown table to
--out (never PROFILE_TRAIN.md, the JAX tool's).

    python -m cocosnet_tpu_torch.tools.profile_train [--batch 8] \\
        [--iters 5] [--platform cpu --crop_size 64 --ngf 8 --ndf 8]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List

import torch

from cocosnet_tpu_torch.tools.profile_inference import (ROOT, flagship_batch,
                                                        flagship_opt)
from cocosnet_tpu_torch.utils import profiling as PR

DEFAULT_OUT = os.path.join(ROOT, "build", "profiles", "profile_train.md")
SEGMENTS = ("preprocess", "G fwd (losses)", "D fwd (losses)", "G adam",
            "D adam", "EMA update", "  one VGG19 tower",
            "G phase (bwd+adam+EMA)", "D phase (bwd+adam)", "full train_step")


def segment_fns(opt, nets, state, batch, device):
    """(name, fn) per segment, in SEGMENTS's order."""
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.nn import layers as L
    from cocosnet_tpu_torch.train import state as S
    from cocosnet_tpu_torch.train import steps as ST
    data = P.preprocess_input(opt, batch, device=device)
    lr = S.lrs_for_epoch(opt, 1)

    def train_mode(fn):
        """fn without gradients, the nets in train mode inside
        nn.layers.training(), as the step runs them."""
        def run():
            nets.set_train(True)
            try:
                with torch.no_grad(), L.training():
                    return fn()
            finally:
                nets.set_train(False)
        return run

    def g_forward():
        noise = P.draw_noise(opt, data, state.noise, train=True)
        out = P.generate_fake(nets, data, train=True, noise=noise)
        out["ref_features"] = P.vgg_features(nets, data["ref_image"])
        out["real_features"] = P.vgg_features(nets, data["real_image"])
        return sum(P.compute_generator_losses(nets, data, out).values()), out

    fake = train_mode(g_forward)()[1]["fake_image"]

    def adam(optimizer, params, rate):
        zeros = [torch.zeros_like(p) for p in params]

        def step():
            for p, z in zip(params, zeros):
                p.grad = z
            S.set_lr(optimizer, rate)
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        return step

    g_step, d_step = ST.make_g_step(nets), ST.make_d_step(nets)
    train_step = ST.make_train_step(nets)
    return list(zip(SEGMENTS, [
        lambda: P.preprocess_input(opt, batch, device=device),
        train_mode(lambda: g_forward()[0]),
        train_mode(lambda: sum(P.compute_discriminator_losses(
            nets, data, fake).values())),
        adam(state.opt_g, list(state.g_params.values()), float(lr[0])),
        adam(state.opt_d, S.d_parameters(nets), float(lr[1])),
        lambda: S.ema_update(state.ema, state.g_params, opt.ema_beta),
        train_mode(lambda: P.vgg_features(nets, data["real_image"])),
        lambda: g_step(state, batch, lr),
        lambda: d_step(state, batch, lr, fake),
        lambda: train_step(state, batch, lr),
    ]))


def run(args) -> List[dict]:
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.cli.common import device_for
    from cocosnet_tpu_torch.nn import layers as L
    from cocosnet_tpu_torch.nn.layers import condition_weights
    from cocosnet_tpu_torch.train import state as S
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
                           ndf=args.ndf, isTrain=True, use_ema=True,
                           weight_mask=100.0,
                           compute_dtype=args.compute_dtype)
        nets = P.Pix2PixNets(opt, device=device, seed=0)
        g = torch.Generator().manual_seed(0)
        for net in nets.modules():
            condition_weights(net, g, device)
        state = S.create_train_state(opt, nets)
        batch = flagship_batch(opt, args.batch)
        print(f"set-up took {time.perf_counter() - t0:.1f} s", flush=True)
        rows = []
        for name, fn in segment_fns(opt, nets, state, batch, device):
            rows.append(PR.measure_stage(name, fn, args.iters, cuda))
            PR.print_stage(rows[-1], args.peak_tflops)
    finally:
        L.set_compute_dtype(policy)
    full = rows[-1]
    print(f"=> {full['ms']:.1f} ms/step, "
          f"{args.batch / (full['ms'] / 1e3):.2f} images/s at batch "
          f"{args.batch}", flush=True)
    table = PR.stage_table(
        rows, "full train_step", args.peak_tflops,
        f"# Train-step profile: ade20k, {args.crop_size} px, batch "
        f"{args.batch}, ngf {args.ngf}, ndf {args.ndf}, "
        f"{args.compute_dtype} policy ({PR.card_line()})")
    print(table, flush=True)
    if args.out:
        PR.write_report(args.out, table)
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--peak_tflops", type=float,
                    default=PR.BF16_FLOP_S / 1e12,
                    help="the card's dense bf16 peak (H100 SXM: 989)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the markdown table ('' writes none)")
    ap.add_argument("--platform", default="",
                    help="'' or gpu: the card (raises without one); cpu: "
                         "the plain versions")
    ap.add_argument("--crop_size", type=int, default=256)
    ap.add_argument("--ngf", type=int, default=64)
    ap.add_argument("--ndf", type=int, default=64)
    ap.add_argument("--compute_dtype", default="bf16", choices=("bf16", "f32"))
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
