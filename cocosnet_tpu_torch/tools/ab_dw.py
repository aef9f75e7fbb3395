"""Per-layer A/B of the dW kernel (csrc/conv3x3_dw.cu) against cuDNN's weight
gradient, on one GPU. Twin of tools/ab_dw.py. It

  1. captures the 3x3 stride-1 convs one flagship train step runs (256 px,
     ngf 64, ndf 64, bf16 policy, batch 8): a spy on nn.layers.conv2d
     records every call a module makes, and the frozen VGG's convs, whose
     weights take no gradient, are left out;
  2. times, per shape, conv3x3_dw against torch.nn.grad.conv2d_weight (the
     op the library route's backward runs) on the same bf16 operands, by
     CUDA events (no dispatch-time subtraction: there is no tunnel);
  3. prints the table, with the shape's count per step and whether the
     COCOSNET_PALLAS_DW=1 gate takes it.

It does not change the gate: ops/conv3x3.DW_WINNERS is the JAX package's
routing. From the repository root:

    python -m cocosnet_tpu_torch.tools.ab_dw [--batch 8] [--iters 20]

`record_convs` and `predicted_launches` are the spy and the routing
prediction that chip_smoke.py holds each path's launch counts to.
"""

from __future__ import annotations

import argparse
import collections
import contextlib

import torch

from cocosnet_tpu_torch.tools import time_ms

# published bf16 tensor-core peak of one H100 SXM (dense), FLOP/s
BF16_FLOP_S = 989e12


def record_convs(fn) -> list:
    """Runs fn() with a spy on nn.layers.conv2d and returns one record per
    call a module makes (conv2d's calls to itself are not recorded): the
    shapes and flags the routing reads, whether the step was inside
    training(), and whether x, the kernel and the bias required grad with
    grad enabled."""
    from cocosnet_tpu_torch.nn import layers as L
    records, depth = [], [0]
    orig = L.conv2d

    def needs_grad(t) -> bool:
        return (torch.is_grad_enabled() and isinstance(t, torch.Tensor)
                and t.requires_grad)

    def spy(x, kernel, bias=None, *, stride=1, padding=0, reflect=False,
            want_stats=False):
        if depth[0] == 0:
            records.append(dict(
                x_shape=tuple(x.shape), kernel_shape=tuple(kernel.shape),
                stride=stride, padding=padding, reflect=reflect,
                want_stats=want_stats, onehot=isinstance(x, L.OneHotLabels),
                training=L._IN_TRAINING, x_grad=needs_grad(x),
                w_grad=needs_grad(kernel), b_grad=needs_grad(bias)))
        depth[0] += 1
        try:
            return orig(x, kernel, bias, stride=stride, padding=padding,
                        reflect=reflect, want_stats=want_stats)
        finally:
            depth[0] -= 1

    L.conv2d = spy
    try:
        fn()
    finally:
        L.conv2d = orig
    return records


def predicted_launches(records) -> collections.Counter:
    """The kernel launches the routing of nn.layers.conv2d predicts for the
    recorded calls under the environment as it stands: one per forward
    kernel; a conv3x3_fused backward (its dx) where x required grad; a
    conv3x3_dw where the kernel or the bias did, on the dW route."""
    from cocosnet_tpu_torch.nn import layers as L
    from cocosnet_tpu_torch.ops import conv3x3 as C
    n = collections.Counter()
    for r in records:
        xs, ks = r["x_shape"], r["kernel_shape"]
        k3s1 = tuple(ks[:2]) == (3, 3) and r["stride"] == 1
        ctx = L.training() if r["training"] else contextlib.nullcontext()
        with ctx:
            if r["onehot"] and k3s1 and r["padding"] == 1 \
                    and not r["reflect"] and L.conv3x3_onehot_supported(
                        xs[:3], xs[3], ks[3]):
                n["conv3x3_onehot"] += 1
                continue
            gate = dict(stride=r["stride"],
                        padding=1 if r["reflect"] else r["padding"])
            if r["want_stats"] and L.conv3x3_stats_supported(xs, ks, **gate):
                n["conv3x3_fused_stats"] += 1
            elif L.conv3x3_supported(xs, ks, **gate):
                n["conv3x3_fused"] += 1
                n["conv3x3_fused_backward"] += int(r["x_grad"])
            elif (r["training"] and k3s1
                  and (r["reflect"] or r["padding"] == 1)
                  and C.conv3x3_dw_supported(xs, ks, reflect=r["reflect"])):
                n["conv3x3_dw"] += int(r["w_grad"] or r["b_grad"])
    return n


def flagship_train_opt(batch: int):
    """The flagship training configuration (bench.py's bench_train)."""
    from cocosnet_tpu_torch import config as cfg
    return cfg.test_defaults(
        dataset_mode="ade20k", label_nc=150, contain_dontcare_label=True,
        crop_size=256, load_size=256, batchSize=batch, ngf=64, ndf=64,
        use_attention=True, maskmix=True, PONO=True, PONO_C=True,
        warp_mask_losstype="direct", match_kernel=3, vgg_normal_correct=True,
        use_ema=True, weight_mask=100.0, isTrain=True)


def random_batch(gen: torch.Generator, b: int, h: int, w: int, nc: int):
    return {
        "label": torch.randint(0, nc, (b, h, w, 1), generator=gen).float(),
        "image": torch.rand(b, h, w, 3, generator=gen) * 2 - 1,
        "ref": torch.rand(b, h, w, 3, generator=gen) * 2 - 1,
        "label_ref": torch.randint(0, nc, (b, h, w, 1), generator=gen).float(),
        "self_ref": torch.ones(b),
    }


def capture_shapes(batch: int) -> collections.Counter:
    """Counter{(B, H, W, Cin, Cout, reflect): convs per step} of the 3x3
    stride-1 convs (reflect or padding 1) of one flagship train step whose
    weights take a gradient, each of which runs one dW in the backward."""
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.nn import layers as L
    from cocosnet_tpu_torch.train import state as TS
    from cocosnet_tpu_torch.train import steps as ST
    opt = flagship_train_opt(batch)
    prev = L.get_compute_dtype()
    L.set_compute_dtype(torch.bfloat16)
    try:
        nets = P.Pix2PixNets(opt, device="cuda", seed=0)
        state = TS.create_train_state(opt, nets)
        step = ST.make_train_step(nets)
        data = random_batch(torch.Generator().manual_seed(0), batch,
                            opt.crop_size, opt.crop_size, opt.semantic_nc)
        records = record_convs(
            lambda: step(state, data, TS.lrs_for_epoch(opt, 1)))
    finally:
        L.set_compute_dtype(prev)
    shapes = collections.Counter()
    for r in records:
        ks = r["kernel_shape"]
        if (r["w_grad"] and tuple(ks[:2]) == (3, 3) and r["stride"] == 1
                and (r["reflect"] or r["padding"] == 1)):
            shapes[r["x_shape"] + (ks[3], r["reflect"])] += 1
    return shapes


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_dw times kernels on a CUDA device; none found")
    from cocosnet_tpu_torch.ops import conv3x3 as C

    shapes = capture_shapes(args.batch)
    gen = torch.Generator().manual_seed(1)
    rows = []
    print(f"{'B,H,W,Cin->Cout,refl':>26s} {'count':>5s} {'cuDNN ms':>9s} "
          f"{'kernel ms':>9s} {'speedup':>7s} {'bound ms':>8s} gate(=1)",
          flush=True)
    for (b, h, w, ci, co, refl), cnt in sorted(shapes.items(),
                                               key=lambda kv: -kv[1]):
        x = torch.randn(b, h, w, ci, generator=gen).to("cuda", torch.bfloat16)
        g = torch.randn(b, h, w, co, generator=gen).to("cuda", torch.bfloat16)
        xc = x.permute(0, 3, 1, 2)
        xp = torch.nn.functional.pad(xc, (1, 1, 1, 1), mode="reflect") \
            if refl else xc
        gc = g.permute(0, 3, 1, 2)
        ms_lib = time_ms(lambda: torch.nn.grad.conv2d_weight(
            xp, (co, ci, 3, 3), gc, padding=0 if refl else 1), args.iters)
        ms_k = time_ms(lambda: C.conv3x3_dw(x, g, reflect=refl), args.iters)
        flops = 2.0 * b * h * w * 9 * ci * co
        nbytes = 2 * b * h * w * (ci + co) + 4 * (9 * ci * co + co)
        bound = 1e3 * max(flops / BF16_FLOP_S, nbytes / 3.35e12)
        gated = (h, w, ci, co, refl) in C.DW_WINNERS
        rows.append(dict(shape=(b, h, w, ci, co, refl), count=cnt,
                         cudnn_ms=ms_lib, kernel_ms=ms_k, bound_ms=bound,
                         winner=gated))
        print(f"{f'{b},{h},{w},{ci}->{co},{int(refl)}':>26s} {cnt:>5d} "
              f"{ms_lib:>9.3f} {ms_k:>9.3f} {ms_lib / ms_k:>7.2f} "
              f"{bound:>8.3f} {'on' if gated else 'off'}", flush=True)
        del x, g, xc, xp, gc
    tot_lib = sum(r["cudnn_ms"] * r["count"] for r in rows)
    tot_k = sum(r["kernel_ms"] * r["count"] for r in rows)
    tot_gate = sum((r["kernel_ms"] if r["winner"] else r["cudnn_ms"])
                   * r["count"] for r in rows)
    print(f"dW time per train step ({sum(shapes.values())} convs): cuDNN "
          f"{tot_lib:.2f} ms, kernel everywhere {tot_k:.2f} ms, the =1 "
          f"gate's routing {tot_gate:.2f} ms", flush=True)
    return rows


if __name__ == "__main__":
    main()
