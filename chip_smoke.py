#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for the
H100): builds the hand-written kernels, holds each against its plain
PyTorch version at the shapes of its main path (and every 3x3 conv shape
of one flagship forward, timed beside cuDNN), runs small inference slices
and small f32 train paths (each loss term's gradient, two steps) on the
card against the plain versions on the CPU, then, at full width (256 px,
ngf 64, ndf 64, 151 classes, bf16 policy, seeded random weights):
- flagship ADE20k inference (match_kernel 3, batch 6) through
  preprocess_input and inference, and flagship training (batch 8, EMA,
  weight_mask 100) through make_train_step;
- the same flags at match_kernel 1 (the dense-descriptor correlation of the
  JAX package's parity runs): inference at batch 6, and training at batch 8
  on both of its routes, the library route (the default) and the kernel
  route (COCOSNET_PALLAS_MK1_TRAIN=1);
- the flagship training step on its two conv routes: the dW kernel
  (COCOSNET_PALLAS_DW=1) and the fused conv with its backward
  (COCOSNET_FUSED_CONV_TRAIN=1);
- the tool twins at their defaults: cocosnet_tpu_torch/tools/ab_dw.py and
  cocosnet_tpu_torch/tools/bench_corr.py (the large-descriptor correlation
  kernels' path);
- the command-line twins, cli/train.py (batch 8; then --D_steps_per_G 2)
  and cli/test.py (batch 6 on the saved state), on
  a synthetic ADE20k tree made from a seed: checkpoints written and loaded
  bit for bit, the test twin's output equal to make_inference_step's;
- the serving path: tools/serve.make_serve_step captured as a CUDA graph
  at match_kernel 3 batch 6 and 1 and match_kernel 1 batch 6 (launches on
  the capture call, replays with the eager forward's bits, graph against
  eager ms and profiles), the serve twin's files against the eager step,
  and tools/bench_serve against the serve twin (batch 6 all at once, npy
  and png; batch 1 at a fixed rate);
- the three other published inference configurations, celebahq (glasses
  at one-hot slot -3, maskmix, --warp_bilinear), celebahqedge (15 dense
  edge channels) and deepfashion (20 pose channels, --warp_patch), each
  with --adaptor_kernel 4 at batch 4: the small-input slice against the
  CPU, the shift9 forward at the warp's width (D 22, 3, 48), the eager
  forward and the serve graph, every conv3x3.cu shape of the forward, and
  the test twin on a synthetic CelebA-HQ tree for the two CelebA-HQ modes
  (deepfashion's pose rendering needs OpenCV, so its path takes seeded
  20-channel labels);
- the training of those three configurations (their published training
  flags; their cycle losses run the correlation with query and key
  swapped, one more shift9 pair a step): small f32 train steps on the card
  against the CPU (and the ade20k cycle mask with --two_cycle), then each
  at full width and batch 8 through make_train_step, then the train twin
  on a synthetic CelebA-HQ tree for the two CelebA-HQ modes with the test
  twin on its checkpoint; phase 2 holds the shift9 backward at their warp
  widths (D 3, 22, 48) and with query and key swapped;
- data and spatial parallelism (phase 11): the shift9 kernels at a query
  shard against all keys (nq != nk) at the 512 px shards of 2 and 4 model
  ranks, against their plain versions and timed; then two processes
  sharing the card over gloo (a card of its own each would take NCCL;
  this machine has one): the 512 px inference and a 128 px train step
  with the correlation's query rows over two model ranks, and the train
  step over two data ranks, each against one process on the same weights
  and batch (and the data ranks' step of the reference's default
  BatchNorm norm); a one-rank NCCL group;
- the architecture branches (phase 12): (a) the reference's default norm
  (a synchronized BatchNorm in every SPADE block, no --PONO): the small
  slice and two small f32 train steps against the CPU, running statistics
  included, the batch-6 serve graph, batch-8 training; (b) the extras
  (coordconv, the SE, nonlocal and deeper dilated adaptors, the CAM
  discriminator, mask noise, noise_for_mask): the batch-6 forward with its
  conv3x3.cu table, batch-8 training without remat, with --remat and with
  --remat --remat_full (s/step, peak memory); (c)
  the explicit-matrix correspondence against the CPU;
- the training trajectory (phase 13) at tools/parity_trajectory.py's
  setting (match_kernel 1, 64 px, batch 2, ngf 64): four f32 steps of the
  kernel route on the card against the CPU, held to
  tests/test_trajectory_parity.py's schedule, then 10 steps each of the
  f32 library, f32 kernel and bf16 kernel routes, finite, their spread
  printed beside PARITY_TRAJECTORY.json's;
- the remaining tool twins (phase 14): profile_inference (mk3 B6) and
  profile_train (mk3 B8), their stage tables with each stage's device time
  by kernel family and its hand-written launches held to phases 4 and 5;
  eval_metrics' VGG19 features on the card against the CPU, SWD and FID;
  mask_to_edge against the celebahqedge loader's label stack;
- --steps_per_dispatch (phase 15): train/steps.make_multi_train_step's
  chunk, the fused step captured once as a CUDA graph and replayed a step
  at a time: (a) at phase 13's setting (match_kernel 3, f32) a chunk of 2
  against two eager steps on the card and against the CPU chunk from the
  same state, then a capture and a replay on every other training route
  (the match_kernel 1 kernels, the dW kernel, the fused conv, --remat,
  --remat_full, the noise draws) against its eager step; (b) the flagship
  mk3 B8 bf16 at K = 4, graph against eager: losses, the launches of the
  capture call and of a replay's kernel records, s/step, idle share, peak
  memory; (c) the train twin at --steps_per_dispatch 4 with a `latest`
  save inside the chunk, a tail step and a resume; (d) a chunk in a
  one-rank NCCL group;
checking on each path that every kernel of that path was launched as often
as the routing predicts (ops/ring's reflect ring, held in phase 2 at the
flagship step's shapes, on every train path by ring width, and on the serve
graphs' capture calls).

    python3 chip_smoke.py

Prints the card's name and power limit, one line per check, a `kernels`
JSON line (per kernel: its main path and its launches there, its
launches on the serve graph's capture call, max error against its plain
version, its time, the plain version's, the library
call's and the least time the card could take; the correlation kernels'
library call is one SDPA call, on the unfolded 3x3 descriptors for the
shift9 pair), the device time of each
path's forward or train step by kernel family (torch.profiler) with the
device's idle share, and as its last line {"ok": true, "device": {...}}.
Exits non-zero, with no such line, if there is no CUDA device, a kernel
does not build or disagrees, or an output is wrong. Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import time
from unittest import mock

import numpy as np
import torch
from PIL import Image as PILImage

from cocosnet_tpu_torch.nn.layers import condition_weights
from cocosnet_tpu_torch.utils.profiling import (
    BF16_FLOP_S, F32_FLOP_S, SPLIT_PASSES, bound_ms, card_line,
    conv3x3_flops, corr_bwd_flops, corr_bwd_issued, corr_fwd_flops,
    corr_fwd_issued, counted_entries, device_ms, onehot_ops, profile_call,
    shift9_bwd_flops, shift9_bwd_issued, shift9_fwd_flops, shift9_fwd_issued,
    tc_bound, time_ms)

def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _check(ok: bool, msg: str) -> None:
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        sys.exit(1)


def _ms(t) -> str:
    return "not measured" if t is None else f"{t:.3f}"


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _maxerr(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _outs(r):
    return r if isinstance(r, tuple) else (r,)


def _phase_done(n: int, t_start: float) -> None:
    print(f"phase {n} done at {time.perf_counter() - t_start:.0f} s",
          flush=True)


# ------------------------------------------------------------------ phase 2

def check_conv(C, g, *, b, h, w, ci, co, reflect, stats, dtype, label):
    """One dense 3x3 conv entry against its plain version; returns the
    record of the case."""
    dev = "cuda"
    x = torch.randn(b, h, w, ci, generator=g).to(dev, dtype)
    k = (torch.randn(3, 3, ci, co, generator=g) * (ci * 9) ** -0.5).to(
        dev, dtype)
    bias = (torch.randn(co, generator=g) * 0.1).to(dev)
    entry = C.conv3x3_fused_stats if stats else C.conv3x3_fused
    got = _outs(entry(x, k, bias, reflect=reflect))
    want = _outs(C.conv3x3_plain(x, k, bias, reflect=reflect,
                                 want_stats=stats))
    torch.cuda.synchronize()
    scale = float(want[0].float().abs().max())
    # f32: K = 9 Cin products summed in another order, ~sqrt(K) ulps of
    # the scale, with margin; bf16: the one output rounding may land one
    # ulp apart
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 3e-5) * scale
    err = _maxerr(got[0], want[0])
    _check(err <= tol, f"{label} {dtype}: out max err {err:.3g} <= {tol:.3g}")
    if stats:
        em, ev = _maxerr(got[1], want[1]), _maxerr(got[2], want[2])
        vtol = 1e-4 * float(want[2].abs().max())
        _check(em <= 1e-5 * scale and ev <= vtol,
               f"{label} {dtype}: mean err {em:.3g}, var err {ev:.3g} "
               f"<= {vtol:.3g}")
    ms = time_ms(lambda: C._conv3x3_kernel(x, k, bias, reflect, None, stats))
    plain_ms = time_ms(lambda: C.conv3x3_plain(x, k, bias, reflect=reflect,
                                               want_stats=stats))
    xc = x.permute(0, 3, 1, 2)
    wc = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bc = bias.to(dtype)
    if reflect:
        lib = lambda: torch.nn.functional.conv2d(  # noqa: E731
            torch.nn.functional.pad(xc, (1, 1, 1, 1), mode="reflect"), wc, bc)
    else:
        lib = lambda: torch.nn.functional.conv2d(  # noqa: E731
            xc, wc, bc, padding=1)
    library_ms = time_ms(lib)
    flops = conv3x3_flops(b, h, w, ci, co)
    nb = _nbytes(x, k, bias) + b * h * w * co * x.element_size()
    bms, by = bound_ms(nb, flops, BF16_FLOP_S if dtype == torch.bfloat16
                       else F32_FLOP_S)
    print(f"     {label} {dtype}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, F.conv2d {library_ms:.3f} ms, bound {bms:.3f} ms ({by})",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


def check_ring(R, g, *, b, h, w, c, p, label):
    """ops/ring's kernel pair at one of the library route's bf16 shapes:
    the forward bit for bit against F.pad of the NCHW view, the backward
    within one rounding of the f64 sum of the gradient (one bf16 ulp of the
    sum of its magnitudes) and the same bits on a second run. Each is timed
    beside its plain version on the card (F.pad of the NCHW view and
    aten's reflection_pad2d_backward on an NCHW gradient, the library
    route's ring before the kernels) and the least time the card could
    take (the input and output bytes once). Returns the forward's and the
    backward's records."""
    F = torch.nn.functional
    x = torch.randn(b, h, w, c, generator=g).to("cuda", torch.bfloat16)
    gy = torch.randn(b, h + 2 * p, w + 2 * p, c,
                     generator=g).to("cuda", torch.bfloat16)
    y = R._ring_fwd(x, p)
    _check(y.is_contiguous() and torch.equal(y, R.reflect_ring_plain(x, p)),
           f"{label}: the forward bit for bit F.pad's")
    d1 = R._ring_bwd(gy, p, x.shape)
    d2 = R._ring_bwd(gy, p, x.shape)

    def f64_sum(gd):
        z = torch.zeros(b, c, h, w, dtype=torch.float64, device="cuda",
                        requires_grad=True)
        (d,) = torch.autograd.grad(F.pad(z, (p,) * 4, mode="reflect"), z,
                                   gd.permute(0, 3, 1, 2))
        return d.permute(0, 2, 3, 1)

    want = f64_sum(gy.double())
    mag = f64_sum(gy.double().abs())
    err = float((d1.double() - want).abs().max())
    _check(bool(((d1.double() - want).abs() <= 2.0 ** -7 * mag).all())
           and torch.equal(d1, d2),
           f"{label}: the backward within one rounding of the f64 sum (max "
           f"err {err:.3g}), the same bits on a second run")
    del want, mag, d1, d2
    ms = time_ms(lambda: R._ring_fwd(x, p))
    bwd_ms = time_ms(lambda: R._ring_bwd(gy, p, x.shape))
    plain_ms = time_ms(lambda: R.reflect_ring_plain(x, p))
    gn = gy.permute(0, 3, 1, 2).contiguous()
    xn = x.permute(0, 3, 1, 2)
    plain_bwd_ms = time_ms(lambda: torch.ops.aten.reflection_pad2d_backward(
        gn, xn, [p] * 4))
    bms, by = bound_ms(_nbytes(x, gy), 0, BF16_FLOP_S)
    print(f"     {label}: forward {ms:.3f} ms (plain {plain_ms:.3f}), "
          f"backward {bwd_ms:.3f} ms (plain {plain_bwd_ms:.3f}), bound "
          f"{bms:.3f} ms ({by}) each", flush=True)
    return (dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                 bound_by=by),
            dict(max_abs_err=err, ms=bwd_ms, plain_ms=plain_bwd_ms,
                 bound_ms=bms, bound_by=by))


def check_onehot(C, g, *, dtype):
    dev = "cuda"
    b, h, w, nc, co = 6, 256, 256, 151, 64
    # ids outside [0, C), the -1 sentinel among them, contribute nothing
    lab = torch.randint(-1, nc + 1, (b, h, w), generator=g).to(dev,
                                                               torch.int32)
    k = (torch.randn(3, 3, nc, co, generator=g) * 0.3).to(dev)
    bias = (torch.randn(co, generator=g) * 0.1).to(dev)
    got = C.conv3x3_onehot(lab, k, bias, dtype=dtype, want_stats=True)
    want = C.onehot_plain(lab, k, bias, dtype=dtype, want_stats=True)
    torch.cuda.synchronize()
    scale = float(want[0].float().abs().max())
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * scale
    errs = [_maxerr(a, c) for a, c in zip(got, want)]
    vtol = 1e-4 * float(want[2].abs().max())
    _check(errs[0] <= tol and errs[1] <= 1e-5 * scale and errs[2] <= vtol,
           f"onehot 151->64 @256^2 stats {dtype}: errs out/mean/var "
           f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} <= "
           f"{tol:.3g}/{1e-5 * scale:.3g}/{vtol:.3g}")
    again = C.conv3x3_onehot(lab, k, bias, dtype=dtype, want_stats=True)
    _check(all(torch.equal(a, c) for a, c in zip(got, again)),
           f"onehot {dtype}: two launches give the same bits (out, mean, "
           f"var)")
    del again
    kd = k.to(dtype)
    ms = time_ms(lambda: C._onehot_kernel(lab, kd, bias, dtype, None, True))
    gather_ms = time_ms(lambda: C._onehot_kernel(lab, kd, bias, dtype, None,
                                                 False))
    # the route not taken: the per-block partials reduced by torch ops
    from cocosnet_tpu_torch.ops import _build
    blocks = _build.library("conv3x3_onehot").cocosnet_onehot_blocks(
        b, h, w, nc, co, int(dtype == torch.bfloat16),
        torch.cuda.get_device_properties(0).multi_processor_count)
    part = torch.rand(b, blocks, 2, co, generator=g).to(dev)
    torch_ms = time_ms(lambda: C._moments(part.sum(dim=1), h * w))
    dev_ms = device_ms(lambda: C._onehot_kernel(lab, kd, bias, dtype, None,
                                                True),
                       ("onehot::onehot_kernel", "onehot::moments_kernel"))
    plain_ms = time_ms(lambda: C.onehot_plain(lab, kd, bias, dtype=dtype,
                                              want_stats=True))
    dense = (lab[..., None] == torch.arange(nc, device=dev)).to(
        dtype).permute(0, 3, 1, 2)
    wc = kd.permute(3, 2, 0, 1).contiguous()
    library_ms = time_ms(lambda: torch.nn.functional.conv2d(
        dense, wc, bias.to(dtype), padding=1))
    out_bytes = b * h * w * co * torch.finfo(dtype).bits // 8
    nb = _nbytes(lab, kd, bias) + out_bytes
    bms, by = bound_ms(nb, onehot_ops(b, h, w, co), F32_FLOP_S)
    print(f"     onehot {dtype}: kernel {ms:.3f} ms (the gather alone "
          f"{gather_ms:.3f}; device time of the gather "
          f"{_ms(dev_ms['onehot::onehot_kernel'])} and of the moments "
          f"launch {_ms(dev_ms['onehot::moments_kernel'])}; torch's "
          f"reduction of the same partials {torch_ms:.3f}), plain "
          f"{plain_ms:.3f} ms, F.conv2d(dense one-hot) {library_ms:.3f} ms, "
          f"bound {bms:.3f} ms ({by}); {nb / ms / 1e6:.0f} GB/s", flush=True)
    return dict(max_abs_err=errs[0], ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


def check_shift9(S, g, *, pono_c, b=6, d=154):
    """The shift9 forward kernel against its plain version at 64 x 64, C
    256 (the flagship's B6 D154 by default; phase 9's B4 at the warp
    widths of the other configurations); returns the record of the case."""
    dev = "cuda"
    h, w, c = 64, 64, 256
    n = h * w
    f = torch.randn(b, h, w, c, generator=g).to(dev)
    gg = (torch.randn(b, h, w, c, generator=g) * 1.5 + 0.2).to(dev)
    v = torch.rand(b, h * w, d, generator=g).to(dev) * 2 - 1
    f3, g3, qv, kv = S.shift9_inputs(f, gg, 0.01, pono_c)
    o, lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    po, plse = S.shift9_core_plain(f3, g3, v, qv, kv, w)
    torch.cuda.synchronize()
    # f32 products over 3C = 768 in another order, times 1/tau = 100 in the
    # logits; the outputs are convex combinations of v in [-1, 1]
    err, lerr = _maxerr(o, po), _maxerr(lse, plse)
    _check(err <= 1e-4 and lerr <= 1e-3,
           f"shift9 B{b} 64x64 C256 D{d} pono_c={pono_c}: o err {err:.3g} "
           f"<= 1e-4, lse err {lerr:.3g} <= 1e-3")
    del po, plse
    ms = time_ms(lambda: S.shift9_core_kernel(f3, g3, v, qv, kv, w))
    parts = S.shift9_fwd_parts(b, n, d, f3.device)
    # the waves: the same launch with the key regions in one part
    with mock.patch.object(S, "shift9_fwd_parts", return_value=1):
        one_ms = time_ms(lambda: S.shift9_core_kernel(f3, g3, v, qv, kv, w))
    dev_ms = device_ms(lambda: S.shift9_core_kernel(f3, g3, v, qv, kv, w),
                       ("shift9_fwd::shift9_fwd_kernel",
                        "shift9_fwd::shift9_fwd_combine_kernel"), runs=5)
    plain_ms = time_ms(lambda: S.shift9_core_plain(f3, g3, v, qv, kv, w),
                       runs=5)
    wrapper_ms = time_ms(lambda: S.attend_shift9(f, gg, v, 0.01, pono_c))
    flops = shift9_fwd_flops(b, n, n, c, d)
    nb = _nbytes(f3, g3, v, qv, kv) + b * n * (d + 1) * 4
    bms, by, tf32_ms, fma_ms = tc_bound(nb, flops)
    issued = shift9_fwd_issued(b, n, 3 * c, d)
    del f3, g3, qv, kv
    torch.cuda.empty_cache()
    lib = shift9_yardstick(f, gg, v, pono_c, o)
    print(f"     shift9 B{b} D{d} pono_c={pono_c}: kernel {ms:.3f} ms "
          f"(device time "
          f"of the flash launch "
          f"{_ms(dev_ms['shift9_fwd::shift9_fwd_kernel'])}, of the combine "
          f"{_ms(dev_ms['shift9_fwd::shift9_fwd_combine_kernel'])}; with the "
          f"torch prep {wrapper_ms:.3f} ms), plain {plain_ms:.3f} ms, "
          f"{lib['library']} {lib['library_ms']:.3f} ms (+ descriptors "
          f"{lib['prep_ms']:.3f} ms), bound {bms:.3f} ms ({by}: "
          f"{flops / 1e9:.1f} GFLOP x {SPLIT_PASSES} bf16 passes; 3xTF32 "
          f"{tf32_ms:.3f} ms; f32 FMA {fma_ms:.3f} ms); the tiles issue "
          f"{issued / 1e9:.1f} GFLOP per pass in {parts} key parts, "
          f"{SPLIT_PASSES * issued / ms / 1e9:.1f} TFLOP/s of TF32 (in one "
          f"part {one_ms:.3f} ms)", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib["library_ms"],
                library=lib["library"], tf32x3_bound_ms=tf32_ms,
                fma_bound_ms=fma_ms)


def shift9_yardstick(f, gg, v, pono_c, o, go=None) -> dict:
    """The library yardstick of the shift9 kernels (never on a path of the
    port): the centered, L2-normalized 3x3-unfold descriptors (C = 9 x 256
    = 2304) that the kernels never form, built as tools/bench_corr.
    descriptor builds them (ops/image.unfold_descriptors), then one
    F.scaled_dot_product_attention f32 call on them, the forward, or with
    an output gradient `go` the forward and backward. First checks that the
    call computes the kernels' function (within 1e-4 of the kernel
    forward's output o); returns its time, the descriptors' own time and
    the SDPA backend that ran."""
    from cocosnet_tpu_torch.tools.bench_corr import descriptor

    def prep():
        return descriptor(f, pono_c), descriptor(gg, pono_c)

    prep_ms = time_ms(prep, runs=5)
    q, k = prep()
    err = _maxerr(sdpa(q, k, v, CORR_TAU), o)
    _check(err <= 1e-4, f"shift9 yardstick pono_c={pono_c}: SDPA on the "
           f"unfolded descriptors vs the kernel: max err {err:.3g} <= 1e-4")
    if go is None:
        what = "forward"

        def lib():
            sdpa(q, k, v, CORR_TAU)
    else:
        what = "forward + backward"
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def lib():
            torch.autograd.grad(sdpa(qr, kr, vr, CORR_TAU), (qr, kr, vr), go)
    ms = time_ms(lib, runs=5)
    backend = sdpa_backend(lib)
    torch.cuda.empty_cache()
    return dict(library_ms=ms, prep_ms=prep_ms,
                library=f"F.scaled_dot_product_attention f32 {what} on the "
                        f"unfolded C = 2304 descriptors, {backend}")


BWD_NAMES = ("dF3", "dqv", "dG3", "dkv", "dV")
# every output of the backward within this fraction of its largest
# magnitude: f32 sums over N keys (or queries) in another order, with 1/tau
# = 100 in the logits; dqs = sum_j gl * logits / qs cancels (gl sums to 0
# over a row), so its error is relative to the logits' scale, not its own
BWD_REL_TOL = 1e-4


def check_shift9_bwd(S, g, *, b, h, w, c, d, pono_c, timed, swap=False):
    """The forward and the backward kernel on one input against their
    plain versions (the backward from the kernel forward's lse and a random
    output gradient); with `swap` the same draws with the roles of query
    and key traded, as the column (cycle) warp calls the kernels; with
    `timed`, the record of the backward."""
    dev = "cuda"
    f = torch.randn(b, h, w, c, generator=g).to(dev)
    gg = (torch.randn(b, h, w, c, generator=g) * 1.5 + 0.2).to(dev)
    if swap:
        f, gg = gg, f
    n = h * w
    v = torch.rand(b, n, d, generator=g).to(dev) * 2 - 1
    go = torch.randn(b, n, d, generator=g).to(dev)
    f3, g3, qv, kv = S.shift9_inputs(f, gg, 0.01, pono_c)
    o, lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    po, plse = S.shift9_core_plain(f3, g3, v, qv, kv, w)
    torch.cuda.synchronize()
    label = (f"shift9 B{b} {h}x{w} C{c} D{d} pono_c={pono_c}"
             + (", roles swapped" if swap else ""))
    err, lerr = _maxerr(o, po), _maxerr(lse, plse)
    _check(err <= 1e-4 and lerr <= 1e-3,
           f"{label} forward: o err {err:.3g} <= 1e-4, lse err {lerr:.3g} "
           f"<= 1e-3")
    del po, plse
    dd = (go * o).sum(-1)
    args = (f3, g3, v, qv, kv, lse, go, dd, w)
    got = S.shift9_bwd_kernel(*args)
    # the yardstick: the plain version in f64 on the same inputs; the f32
    # plain version is itself up to 1.2e-4 of dqv's largest magnitude from
    # it on some draws (tools/shift9_bwd_accuracy.py)
    exact = S.shift9_bwd_plain(*(a.double() if torch.is_tensor(a) else a
                                 for a in args))
    plain = S.shift9_bwd_plain(*args)
    torch.cuda.synchronize()
    scales = [float(r.abs().max()) for r in exact]
    errs = [_maxerr(a, r) for a, r in zip(got, exact)]
    perrs = [_maxerr(a, r) for a, r in zip(plain, exact)]
    kperrs = [_maxerr(a, r) for a, r in zip(got, plain)]
    del exact, plain
    torch.cuda.empty_cache()
    _check(all(e <= BWD_REL_TOL * s for e, s in zip(errs, scales)),
           f"{label} backward kernel vs the f64 plain version: max err / "
           "max |out| " + ", ".join(
               f"{nm} {e / s:.3g}" for nm, e, s in zip(BWD_NAMES, errs,
                                                       scales))
           + f" <= {BWD_REL_TOL:g} (3xTF32, f32 sums reordered, 1/tau in "
             f"the logits)")
    worst = max(e / s for e, s in zip(perrs, scales))
    _check(worst <= BWD_REL_TOL,
           f"{label} backward, the f32 plain version vs the f64 one: max "
           "err / max |out| " + ", ".join(
               f"{nm} {e / s:.3g}" for nm, e, s in zip(BWD_NAMES, perrs,
                                                       scales))
           + f" <= {BWD_REL_TOL:g}"
           + ("" if worst <= BWD_REL_TOL else
              f" (MISSED by {worst / BWD_REL_TOL:.3f}x)"))
    print(f"     {label} backward kernel vs the f32 plain version: "
          + ", ".join(f"{nm} {e / s:.3g}" for nm, e, s in zip(
              BWD_NAMES, kperrs, scales)), flush=True)
    if not timed:
        return None
    fwd_ms = time_ms(lambda: S.shift9_core_kernel(f3, g3, v, qv, kv, w))
    rate = SPLIT_PASSES * shift9_fwd_issued(b, n, 3 * c, d) / fwd_ms / 1e9
    print(f"     {label} forward: kernel {fwd_ms:.3f} ms "
          f"in {S.shift9_fwd_parts(b, n, d, f3.device)} key parts, "
          f"{rate:.1f} TFLOP/s of TF32", flush=True)
    forward = None
    if swap:
        # the column warp's forward row: its plain version and the SDPA
        # forward beside it
        fwd_plain_ms = time_ms(
            lambda: S.shift9_core_plain(f3, g3, v, qv, kv, w), runs=3)
        fwd_lib = shift9_yardstick(f, gg, v, pono_c, o)
        fwd_bms, fwd_by, _, _ = tc_bound(
            _nbytes(f3, g3, v, qv, kv) + b * n * (d + 1) * 4,
            shift9_fwd_flops(b, n, n, c, d))
        print(f"     {label} forward: plain {fwd_plain_ms:.3f} ms, "
              f"{fwd_lib['library']} {fwd_lib['library_ms']:.3f} ms, bound "
              f"{fwd_bms:.3f} ms ({fwd_by})", flush=True)
        forward = dict(max_abs_err=err, ms=fwd_ms, plain_ms=fwd_plain_ms,
                       bound_ms=fwd_bms, bound_by=fwd_by,
                       library_ms=fwd_lib["library_ms"],
                       library=fwd_lib["library"])
    again = S.shift9_bwd_kernel(*args)
    _check(all(torch.equal(a, r) for a, r in zip(got, again)),
           f"{label} backward: two launches give the same bits")
    del again
    ms = time_ms(lambda: S.shift9_bwd_kernel(*args), runs=5)
    plain_ms = time_ms(lambda: S.shift9_bwd_plain(*args), runs=3)
    torch.cuda.empty_cache()
    lib = shift9_yardstick(f, gg, v, pono_c, o, go)
    c3 = 3 * c
    # the function needs S3 = F3 G3^T and dP = gO V^T once each, then dF3 =
    # dS3 G3, dG3 = dS3^T F3 and dV = P^T gO: 2 B N^2 (3 3C + 2 D), each as 3
    # split passes for the bound; the tiles' padded count is printed beside
    flops = shift9_bwd_flops(b, n, n, c, d)
    issued = shift9_bwd_issued(b, n, c3, d)
    nb = _nbytes(f3, g3, v, qv, kv, lse, go, dd, *got)
    bms, by, tf32_ms, fma_ms = tc_bound(nb, flops)
    print(f"     {label} backward: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, {lib['library']} {lib['library_ms']:.3f} ms "
          f"(+ descriptors {lib['prep_ms']:.3f} ms), bound {bms:.3f} ms "
          f"({by}: {flops / 1e9:.1f} GFLOP x {SPLIT_PASSES} bf16 passes; "
          f"3xTF32 {tf32_ms:.3f} ms; f32 FMA {fma_ms:.3f} ms); the tiles "
          f"issue {issued / 1e9:.1f} GFLOP per pass, "
          f"{SPLIT_PASSES * issued / ms / 1e9:.1f} TFLOP/s of TF32",
          flush=True)
    rec = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, library_ms=lib["library_ms"],
               library=lib["library"], tf32x3_bound_ms=tf32_ms,
               fma_bound_ms=fma_ms)
    if forward is not None:
        rec["forward"] = forward
    return rec


def corr_inputs(g, b, n, m, c=256, d=154):
    """Unit-norm descriptors q (B, N, C) and k (B, M, C), as the
    correspondence net hands them over, values v (B, M, D) in [-1, 1]."""
    dev = "cuda"
    q = torch.nn.functional.normalize(torch.randn(b, n, c, generator=g),
                                      dim=-1).to(dev)
    k = torch.nn.functional.normalize(torch.randn(b, m, c, generator=g),
                                      dim=-1).to(dev)
    v = torch.rand(b, m, d, generator=g).to(dev) * 2 - 1
    return q, k, v


def sdpa(q, k, v, tau):
    """The library yardstick: one F.scaled_dot_product_attention call on
    the same (B, N, C) inputs, as one head. Never on a path of the port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, None], k[:, None], v[:, None], scale=1.0 / tau)[:, 0]


def sdpa_backend(fn) -> str:
    """Which SDPA implementation ran, from the names of the device kernels
    one call of `fn` launched."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.name.lower() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    for key, what in (("flash", "flash"), ("fmha", "memory-efficient"),
                      ("efficient", "memory-efficient"), ("cudnn", "cuDNN")):
        if key in names:
            return what
    return "math (matmul + softmax)" if names else "not measured"


CORR_TAU = 0.01


def check_corr(Kc, g, *, b, n, timed):
    """The forward kernel against its plain version at (B, N = M, C 256, D
    154); with `timed`, its record with the plain and the SDPA times."""
    q, k, v = corr_inputs(g, b, n, n)
    o, lse = Kc.corr_fwd_kernel(q, k, v, CORR_TAU)
    po, plse = Kc.corr_fwd_plain(q, k, v, CORR_TAU)
    torch.cuda.synchronize()
    # f32 products over C = 256 in another order, times 1/tau = 100 in the
    # logits; the outputs are convex combinations of v in [-1, 1]
    err, lerr = _maxerr(o, po), _maxerr(lse, plse)
    _check(err <= 1e-4 and lerr <= 1e-3,
           f"corr forward B{b} N=M={n} C256 D154: o err {err:.3g} <= 1e-4, "
           f"lse err {lerr:.3g} <= 1e-3")
    del po, plse
    if not timed:
        return None
    ms = time_ms(lambda: Kc.corr_fwd_kernel(q, k, v, CORR_TAU))
    plain_ms = time_ms(lambda: Kc.corr_fwd_plain(q, k, v, CORR_TAU), runs=5)
    lib = lambda: sdpa(q, k, v, CORR_TAU)  # noqa: E731
    library_ms = time_ms(lib, runs=5)
    backend = sdpa_backend(lib)
    torch.cuda.empty_cache()
    flops = corr_fwd_flops(b, n, n, 256, 154)
    issued = corr_fwd_issued(b, n, n, 256, 154)
    nb = _nbytes(q, k, v, o, lse)
    bms, by, tf32_ms, fma_ms = tc_bound(nb, flops)
    print(f"     corr forward B{b} N=M={n}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, SDPA f32 ({backend}) {library_ms:.3f} ms, "
          f"bound {bms:.3f} ms ({by}: {flops / 1e9:.2f} GFLOP x "
          f"{SPLIT_PASSES} bf16 passes; 3xTF32 {tf32_ms:.3f} ms; f32 FMA "
          f"{fma_ms:.3f} ms); the tiles issue {issued / 1e9:.1f} GFLOP per "
          f"pass, {SPLIT_PASSES * issued / ms / 1e9:.1f} TFLOP/s of TF32",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms,
                library=f"F.scaled_dot_product_attention f32, {backend}",
                tf32x3_bound_ms=tf32_ms, fma_bound_ms=fma_ms)


def check_corr_bwd(Kc, g, *, b, n, timed):
    """The backward kernel against its plain version at (B, N = M, C 256,
    D 154), from the kernel forward's lse and a random output gradient; with
    `timed`, a determinism check and its record, the library time being
    SDPA's forward and backward."""
    q, k, v = corr_inputs(g, b, n, n)
    go = torch.randn(b, n, 154, generator=g).to("cuda")
    o, lse = Kc.corr_fwd_kernel(q, k, v, CORR_TAU)
    args = (q, k, v, CORR_TAU, lse, go, (go * o).sum(-1))
    got = Kc.corr_bwd_kernel(*args)
    want = Kc.corr_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = [_maxerr(a, r) for a, r in zip(got, want)]
    scales = [float(r.abs().max()) for r in want]
    del want
    torch.cuda.empty_cache()
    _check(all(e <= BWD_REL_TOL * s for e, s in zip(errs, scales)),
           f"corr backward B{b} N=M={n} C256 D154: max err / max |out| "
           + ", ".join(f"{nm} {e:.3g}/{s:.3g}"
                       for nm, e, s in zip(("dq", "dk", "dv"), errs, scales))
           + f" <= {BWD_REL_TOL:g} (f32 sums reordered, 1/tau in the logits)")
    if not timed:
        return None
    again = Kc.corr_bwd_kernel(*args)
    _check(all(torch.equal(a, r) for a, r in zip(got, again)),
           f"corr backward B{b} N=M={n}: two launches give the same bits")
    del again
    ms = time_ms(lambda: Kc.corr_bwd_kernel(*args), runs=5)
    plain_ms = time_ms(lambda: Kc.corr_bwd_plain(*args), runs=3)
    torch.cuda.empty_cache()
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def lib():
        torch.autograd.grad(sdpa(qr, kr, vr, CORR_TAU), (qr, kr, vr), go)

    library_ms = time_ms(lib, runs=3)
    backend = sdpa_backend(lib)
    torch.cuda.empty_cache()
    # the function needs S = q k^T and dP = gO v^T once each, then dq, dk
    # and dv: 2 B N M (3 C + 2 D), each as 3 split passes for the bound; the
    # tiles' padded count is printed beside it
    flops = corr_bwd_flops(b, n, n, 256, 154)
    issued = corr_bwd_issued(b, n, n, 256, 154, 96)
    nb = _nbytes(*args[:3], *args[4:], *got)
    bms, by, tf32_ms, fma_ms = tc_bound(nb, flops)
    print(f"     corr backward B{b} N=M={n}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, SDPA f32 forward + backward ({backend}) "
          f"{library_ms:.3f} ms, bound {bms:.3f} ms ({by}: {flops / 1e9:.1f}"
          f" GFLOP x {SPLIT_PASSES} bf16 passes; 3xTF32 {tf32_ms:.3f} ms; "
          f"f32 FMA {fma_ms:.3f} ms); the tiles issue {issued / 1e9:.1f} "
          f"GFLOP per pass, {SPLIT_PASSES * issued / ms / 1e9:.1f} TFLOP/s "
          f"of TF32", flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=library_ms,
                library=f"F.scaled_dot_product_attention f32 forward + "
                        f"backward, {backend}", tf32x3_bound_ms=tf32_ms,
                fma_bound_ms=fma_ms)


# each dW and db within this fraction of its largest magnitude: f32 sums
# over K = B H W = 32768..131072 products in another order (the products of
# bf16 operands are exact in f32; WMMA's accumulation over one 32768-row
# split at 512->512 measured 4.0e-5)
DW_REL_TOL = 1e-4


def check_dw(C, g, *, b, h, w, ci, co, reflect, dtype, timed):
    """conv3x3_dw's kernel against its plain version on one shape, and a
    determinism check (two launches, the same bits); with `timed`, its
    record beside cuDNN's weight gradient."""
    dev = "cuda"
    x = torch.randn(b, h, w, ci, generator=g).to(dev, dtype)
    gy = torch.randn(b, h, w, co, generator=g).to(dev, dtype)
    got = C._conv3x3_dw_kernel(x, gy, reflect)
    want = C.conv3x3_dw_plain(x, gy, reflect=reflect)
    torch.cuda.synchronize()
    errs = [_maxerr(a, r) for a, r in zip(got, want)]
    scales = [float(r.abs().max()) for r in want]
    label = (f"dw {ci}->{co} @{h}x{w} B{b} {'reflect' if reflect else 'zero'}"
             f" {dtype}")
    _check(all(e <= DW_REL_TOL * s for e, s in zip(errs, scales)),
           f"{label}: max err / max |out| dw {errs[0]:.3g}/{scales[0]:.3g}, "
           f"db {errs[1]:.3g}/{scales[1]:.3g} <= {DW_REL_TOL:g} (f32 sums "
           f"reordered)")
    again = C._conv3x3_dw_kernel(x, gy, reflect)
    _check(all(torch.equal(a, r) for a, r in zip(got, again)),
           f"{label}: two launches give the same bits")
    if not timed:
        return None
    ms = time_ms(lambda: C._conv3x3_dw_kernel(x, gy, reflect))
    plain_ms = time_ms(lambda: C.conv3x3_dw_plain(x, gy, reflect=reflect))
    xc = x.permute(0, 3, 1, 2)
    xp = torch.nn.functional.pad(xc, (1, 1, 1, 1), mode="reflect") \
        if reflect else xc
    gc = gy.permute(0, 3, 1, 2)
    library_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
        xp, (co, ci, 3, 3), gc, padding=0 if reflect else 1))
    flops = conv3x3_flops(b, h, w, ci, co)
    nb = _nbytes(x, gy, *got)
    bms, by = bound_ms(nb, flops, BF16_FLOP_S if dtype == torch.bfloat16
                       else F32_FLOP_S)
    print(f"     {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"cuDNN weight gradient {library_ms:.3f} ms, bound {bms:.3f} ms "
          f"({by}, {flops / 1e9:.2f} GFLOP)", flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=library_ms,
                library="torch.nn.grad.conv2d_weight (cuDNN wgrad)")


def check_fused_bwd(C, g, *, b, h, w, ci, co, dtype):
    """conv3x3_fused's backward on the card against its plain version (the
    same backward with the plain dx conv), and the record of its kernel
    launch: the zero-ring conv of g with the rotated kernel."""
    dev = "cuda"
    x = torch.randn(b, h, w, ci, generator=g).to(dev, dtype)
    k = (torch.randn(3, 3, ci, co, generator=g) * (ci * 9) ** -0.5).to(
        dev, dtype)
    gy = torch.randn(b, h, w, co, generator=g).to(dev, dtype)
    need = (True, False, False)
    got = C.conv3x3_fused_backward(x, k, None, gy, reflect=True,
                                   need=need)[0]
    want = C.conv3x3_fused_backward_plain(x, k, None, gy, reflect=True,
                                          need=need)[0]
    torch.cuda.synchronize()
    scale = float(want.float().abs().max())
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 3e-5) * scale
    err = _maxerr(got, want)
    label = f"fused backward dx {ci}->{co} @{h}x{w} B{b} reflect {dtype}"
    _check(err <= tol, f"{label}: max err {err:.3g} <= {tol:.3g} (the ring "
           f"scatter rounds once more in {dtype})")
    krot = k.flip(0, 1).transpose(2, 3).contiguous()
    ms = time_ms(lambda: C._conv3x3_kernel(gy, krot, None, False, None,
                                           False))
    plain_ms = time_ms(lambda: C.conv3x3_plain(gy, krot, None))
    wc = k.permute(3, 2, 0, 1)
    gc = gy.permute(0, 3, 1, 2)
    library_ms = time_ms(lambda: torch.nn.grad.conv2d_input(
        (b, ci, h, w), wc, gc, padding=1))
    flops = conv3x3_flops(b, h, w, ci, co)
    nb = _nbytes(gy, k) + b * h * w * ci * x.element_size()
    bms, by = bound_ms(nb, flops, BF16_FLOP_S if dtype == torch.bfloat16
                       else F32_FLOP_S)
    print(f"     {label}: dx kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"cuDNN input gradient {library_ms:.3f} ms, bound {bms:.3f} ms "
          f"({by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms,
                library="torch.nn.grad.conv2d_input (cuDNN dgrad)")


BIGC_C, BIGC_D = 2304, 3


def check_bigc(Kc, TC, g, *, b, n, m, timed):
    """The large-descriptor forward (corr_fwd.cu at C = 2304) against its
    plain version; with `timed`, its record beside SDPA and the library
    route's attend_chunked."""
    q, k, v = corr_inputs(g, b, n, m, c=BIGC_C, d=BIGC_D)
    o, lse = Kc.corr_fwd_kernel(q, k, v, CORR_TAU)
    po, plse = Kc.corr_fwd_plain(q, k, v, CORR_TAU)
    torch.cuda.synchronize()
    err, lerr = _maxerr(o, po), _maxerr(lse, plse)
    label = f"bigc forward B{b} N={n} M={m} C{BIGC_C} D{BIGC_D}"
    _check(err <= 1e-4 and lerr <= 1e-3,
           f"{label}: o err {err:.3g} <= 1e-4, lse err {lerr:.3g} <= 1e-3 "
           f"(f32 sums over C in another order, 1/tau in the logits)")
    del po, plse
    if not timed:
        return None
    ms = time_ms(lambda: Kc.corr_fwd_kernel(q, k, v, CORR_TAU), runs=5)
    plain_ms = time_ms(lambda: Kc.corr_fwd_plain(q, k, v, CORR_TAU), runs=5)
    lib = lambda: sdpa(q, k, v, CORR_TAU)  # noqa: E731
    library_ms = time_ms(lib, runs=5)
    backend = sdpa_backend(lib)
    chunked_ms = time_ms(lambda: TC.attend_chunked(q, k, v, CORR_TAU),
                         runs=5)
    torch.cuda.empty_cache()
    flops = corr_fwd_flops(b, n, m, BIGC_C, BIGC_D)
    issued = corr_fwd_issued(b, n, m, BIGC_C, BIGC_D)
    nb = _nbytes(q, k, v, o, lse)
    bms, by, tf32_ms, fma_ms = tc_bound(nb, flops)
    print(f"     {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA "
          f"f32 ({backend}) {library_ms:.3f} ms, attend_chunked "
          f"{chunked_ms:.3f} ms, bound {bms:.3f} ms ({by}: "
          f"{flops / 1e9:.1f} GFLOP x {SPLIT_PASSES} bf16 passes; 3xTF32 "
          f"{tf32_ms:.3f} ms; f32 FMA {fma_ms:.3f} ms); the tiles issue "
          f"{issued / 1e9:.1f} GFLOP per pass, "
          f"{SPLIT_PASSES * issued / ms / 1e9:.1f} TFLOP/s of TF32",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms,
                library=f"F.scaled_dot_product_attention f32, {backend}",
                tf32x3_bound_ms=tf32_ms, fma_bound_ms=fma_ms)


def check_bigc_bwd(Kc, KB, TC, g, *, b, n, m, timed):
    """corr_bwd.cu at C 2304 against its plain version (corr_bwd_plain),
    from the kernel forward's lse and a random output gradient; with
    `timed`, a determinism check and its record beside SDPA's and
    attend_chunked's forward + backward."""
    q, k, v = corr_inputs(g, b, n, m, c=BIGC_C, d=BIGC_D)
    go = torch.randn(b, n, BIGC_D, generator=g).to("cuda")
    o, lse = Kc.corr_fwd_kernel(q, k, v, CORR_TAU)
    args = (q, k, v, CORR_TAU, lse, go, (go * o).sum(-1))
    got = KB.corr_bigc_bwd_kernel(*args)
    want = Kc.corr_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = [_maxerr(a, r) for a, r in zip(got, want)]
    scales = [float(r.abs().max()) for r in want]
    del want
    torch.cuda.empty_cache()
    label = f"bigc backward B{b} N={n} M={m} C{BIGC_C} D{BIGC_D}"
    _check(all(e <= BWD_REL_TOL * s for e, s in zip(errs, scales)),
           f"{label}: max err / max |out| "
           + ", ".join(f"{nm} {e:.3g}/{s:.3g}"
                       for nm, e, s in zip(("dq", "dk", "dv"), errs, scales))
           + f" <= {BWD_REL_TOL:g} (f32 sums reordered, 1/tau in the logits)")
    if not timed:
        return None
    again = KB.corr_bigc_bwd_kernel(*args)
    _check(all(torch.equal(a, r) for a, r in zip(got, again)),
           f"{label}: two launches give the same bits")
    del again
    ms = time_ms(lambda: KB.corr_bigc_bwd_kernel(*args), runs=3)
    plain_ms = time_ms(lambda: Kc.corr_bwd_plain(*args), runs=3)
    torch.cuda.empty_cache()
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def lib():
        torch.autograd.grad(sdpa(qr, kr, vr, CORR_TAU), (qr, kr, vr), go)

    library_ms = time_ms(lib, runs=3)
    backend = sdpa_backend(lib)
    chunked_ms = time_ms(lambda: torch.autograd.grad(
        TC.attend_chunked(qr, kr, vr, CORR_TAU), (qr, kr, vr), go), runs=3)
    torch.cuda.empty_cache()
    c, d = BIGC_C, BIGC_D
    flops = corr_bwd_flops(b, n, m, c, d)
    issued = corr_bwd_issued(b, n, m, c, d, 32)
    nb = _nbytes(*args[:3], *args[4:], *got)
    bms, by, tf32_ms, fma_ms = tc_bound(nb, flops)
    print(f"     {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA "
          f"f32 forward + backward ({backend}) {library_ms:.3f} ms, "
          f"attend_chunked forward + backward {chunked_ms:.3f} ms, bound "
          f"{bms:.3f} ms ({by}: {flops / 1e12:.3f} TFLOP x {SPLIT_PASSES} "
          f"bf16 passes; 3xTF32 {tf32_ms:.3f} ms; f32 FMA {fma_ms:.3f} ms);"
          f" the tiles issue {issued / 1e12:.3f} TFLOP per pass, "
          f"{SPLIT_PASSES * issued / ms / 1e9:.1f} TFLOP/s of TF32",
          flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=library_ms,
                library=f"F.scaled_dot_product_attention f32 forward + "
                        f"backward, {backend}", tf32x3_bound_ms=tf32_ms,
                fma_bound_ms=fma_ms)


# ------------------------------------------------------------------ phase 3

def _launches(**kw) -> dict:
    """Launches per forward or step: the named counts, every other 0."""
    return {k: kw.get(k, 0) for k in counted_entries()}


CONVS = dict(conv3x3_fused=80, conv3x3_fused_stats=20, conv3x3_onehot=1)
# per flagship-width inference forward, by match_kernel
INFERENCE_LAUNCHES = {3: _launches(attend_shift9=1, **CONVS),
                      1: _launches(attend_corr=1, **CONVS)}
SHIFT9 = dict(attend_shift9=1, attend_shift9_backward=1)
# per flagship train step, by (match_kernel, route). The shift9 core runs
# its kernels forward and backward; match_kernel 1 runs the library attend,
# or attend_corr's kernels on the kernel route. By default every conv is a
# library conv (nn.layers.training). On the conv routes, the counts of
# tools/ab_dw.predicted_launches over tools/ab_dw.record_convs of one step:
# COCOSNET_PALLAS_DW=1 takes dW of the 70 trainable convs of the winners
# table (40 of 128->512 @64^2, 12 of 512->512, 8 of 128->256, 4 of
# 256->256, 3 + 3 of 154->128 @64^2 and @128^2); COCOSNET_FUSED_CONV_TRAIN
# =1 runs the 128 convs of the fused gate on conv3x3.cu (the generator's and
# the correspondence net's, and the VGG's on the fake, the ref and the real
# image; the 16 407->407 convs stay on the library by the pad-ratio rule),
# and a dx launch for the 106 of them whose input takes a gradient (not the
# first convs on the data, nor the VGG's under no_grad)
# The other configurations' steps (phase 10) run the shift9 pair once for
# the row warp and once more for each column (cycle) warp: celebahq and
# celebahqedge the warp's cycle (--warp_cycle_w), deepfashion none; the
# ade20k cycle family (the cycle mask with --two_cycle) the label map's
# column warp and its row warp back, the warp's cycle, and the real image's
# column warp and its row warp back
TRAIN_LAUNCHES = {(3, "kernels"): _launches(**SHIFT9),
                  (1, "library"): _launches(),
                  (1, "kernels"): _launches(attend_corr=1,
                                            attend_corr_backward=1),
                  (3, "dw"): _launches(conv3x3_dw=70, **SHIFT9),
                  (3, "fused"): _launches(conv3x3_fused=128,
                                          conv3x3_fused_backward=106,
                                          **SHIFT9),
                  "celebahq": _launches(attend_shift9=2,
                                        attend_shift9_backward=2),
                  "celebahqedge": _launches(attend_shift9=2,
                                            attend_shift9_backward=2),
                  "deepfashion": _launches(**SHIFT9),
                  "ade20k cycle": _launches(attend_shift9=6,
                                            attend_shift9_backward=6)}


@contextlib.contextmanager
def train_route(route: str):
    """The switches of a train route, all others at their defaults (unset):
    "library" (every default), "kernels" (match_kernel 1 on attend_corr's
    kernels, COCOSNET_PALLAS_MK1_TRAIN=1), "dw" or "dw all"
    (COCOSNET_PALLAS_DW=1 or =all), "fused" (COCOSNET_FUSED_CONV_TRAIN=1)."""
    from cocosnet_tpu_torch.models import correspondence as CR
    from cocosnet_tpu_torch.nn import layers as L
    from cocosnet_tpu_torch.ops import conv3x3 as C

    def clear():
        os.environ.pop(CR.MK1_TRAIN_ENV, None)
        os.environ.pop(C.DW_ENV, None)
        os.environ.pop(L.FUSED_TRAIN_ENV, None)

    clear()
    if route == "kernels":
        os.environ[CR.MK1_TRAIN_ENV] = "1"
    elif route in ("dw", "dw all"):
        os.environ[C.DW_ENV] = "all" if route == "dw all" else "1"
    elif route == "fused":
        os.environ[L.FUSED_TRAIN_ENV] = "1"
    try:
        yield
    finally:
        clear()


def _corr_launches(match_kernel, route) -> dict:
    """The correlation kernels' part of a step's launches on `route`."""
    return _attend_part(TRAIN_LAUNCHES[
        (match_kernel, route if match_kernel == 1 else "kernels")])


def _attend_part(launches) -> dict:
    return {k: v for k, v in launches.items() if k.startswith("attend")}


def _zero_counts(counted) -> None:
    for fn in counted.values():
        fn.launches = 0


RING_ENTRIES = ("reflect_ring", "reflect_ring_backward")


def _ring_counts() -> dict:
    """ops/ring's launches since RING_LAUNCHES was cleared: each way's
    total, and by ring width p ("reflect_ring p1", ...)."""
    from cocosnet_tpu_torch.ops import ring as R
    n = dict.fromkeys(RING_ENTRIES, 0)
    for (way, _, p), k in R.RING_LAUNCHES.items():
        name = RING_ENTRIES[way == "bwd"]
        n[name] += k
        n[f"{name} p{p}"] = n.get(f"{name} p{p}", 0) + k
    return n


def ring_launch_check(records, tag, recomputes=False) -> dict:
    """ops/ring's launches since RING_LAUNCHES was cleared against those
    the routing predicts from the recorded convs
    (tools/ab_dw.predicted_ring_launches), each way by ring width. Where
    the step recomputes (--remat) only the forward is held here: a conv
    recomputed in the backward records an x that takes a gradient, and no
    backward runs through it (the caller holds the backward to the same
    step without --remat). Returns _ring_counts()."""
    from cocosnet_tpu_torch.ops import ring as R
    from cocosnet_tpu_torch.tools import ab_dw as AB
    got = collections.Counter()
    for (way, _, p), k in R.RING_LAUNCHES.items():
        got[(way, p)] += k
    want = AB.predicted_ring_launches(records)
    if recomputes:
        got, want = ({k: v for k, v in c.items() if k[0] == "fwd"}
                     for c in (got, want))
    dtypes = sorted({str(k[1]) for k in R.RING_LAUNCHES})
    _check(dict(+collections.Counter(got)) == dict(want),
           f"{tag}: the reflect ring launched {dict(got)} ({dtypes}), as "
           f"the routing predicts from the step's {len(records)} convs"
           + (" (forward only: --remat)" if recomputes else ""))
    return _ring_counts()


def make_batch(g, b, h, w, nc):
    return {
        "label": torch.randint(0, nc, (b, h, w, 1), generator=g).float(),
        "image": torch.rand(b, h, w, 3, generator=g) * 2 - 1,
        "ref": torch.rand(b, h, w, 3, generator=g) * 2 - 1,
        "label_ref": torch.randint(0, nc, (b, h, w, 1), generator=g).float(),
        "self_ref": torch.ones(b),
    }


def reference_check(P, cfg, g, match_kernel, flags=None, tag=""):
    """The whole slice on the card (kernels, f32) against the same weights
    and batch through the plain versions on the CPU, at a small input
    (128 x 256, ngf 16, 13 classes: a 32 x 64 feature map) that takes the
    correlation kernel of the path and both dense conv kernels; the one-hot
    conv's gate wants Cout >= 64 and densifies the labels at ngf 16, as the
    JAX gate does (phase 2's onehot check and the flagship forward hold that
    kernel). The launches must be what the routing predicts from the
    forward's recorded convs; atol 5e-4 as the CPU parity tests hold the
    slice against the JAX package."""
    from cocosnet_tpu_torch.tools import ab_dw as AB
    opt = cfg.test_defaults(**{**dict(
        dataset_mode="ade20k", label_nc=12, contain_dontcare_label=True,
        crop_size=256, load_size=256, aspect_ratio=2.0, batchSize=1, ngf=16,
        use_attention=True, maskmix=True, PONO=True, PONO_C=True,
        warp_mask_losstype="direct", match_kernel=match_kernel,
        isTrain=False), **(flags or {})})
    batch = make_batch(g, 1, 128, 256, opt.semantic_nc)
    cpu = P.Pix2PixNets(opt, device="cpu", seed=1)
    condition_weights(cpu.corr, g, "cpu")
    condition_weights(cpu.gen, g, "cpu")
    gpu = P.Pix2PixNets(opt, device="cuda", seed=1)
    gpu.corr.load_state_dict(cpu.corr.state_dict())
    gpu.gen.load_state_dict(cpu.gen.state_dict())
    want = P.inference(cpu, P.preprocess_input(opt, batch, device="cpu"))
    counted = counted_entries()
    _zero_counts(counted)
    res = []
    records = AB.record_convs(lambda: res.append(P.inference(
        gpu, P.preprocess_input(opt, batch, device="cuda"))))
    got = res[0]
    moved = {k: fn.launches for k, fn in counted.items()}
    corr = {k: n for k, n in INFERENCE_LAUNCHES[match_kernel].items()
            if k.startswith("attend") and n}
    predicted = _launches(**corr, **AB.predicted_launches(records))
    _check(moved == predicted and all(
        moved[k] for k in ("conv3x3_fused", "conv3x3_fused_stats", *corr)),
        f"match_kernel {match_kernel}{tag} small input launched {moved} == "
        f"{predicted}, the routing's prediction, the correlation kernel and "
        f"both dense conv kernels among them")
    for key in ("fake_image", "warp_out", "warp_mask"):
        err = _maxerr(got[key].cpu(), want[key])
        _check(err <= 5e-4, f"match_kernel {match_kernel}{tag} small-input "
               f"slice "
               f"on the card vs plain on the CPU, {key}: max err {err:.3g} "
               f"<= 5e-4")


def train_opt(cfg, **kw):
    """The flagship training configuration (bench.py's bench_train):
    ade20k flags, TTUR, EMA, weight_mask 100, vgg_normal_correct; kw may
    set match_kernel 1."""
    base = dict(dataset_mode="ade20k", contain_dontcare_label=True,
                use_attention=True, maskmix=True, PONO=True, PONO_C=True,
                warp_mask_losstype="direct", match_kernel=3,
                vgg_normal_correct=True, use_ema=True, weight_mask=100.0,
                isTrain=True)
    return cfg.test_defaults(**{**base, **kw})


TRAINED = ("gen", "corr", "disc")


def _params(nets) -> dict:
    """{net: {name: parameter}} of the trained networks, f64 on the CPU."""
    return {net: {k: p.detach().cpu().double()
                  for k, p in getattr(nets, net).named_parameters()}
            for net in TRAINED}


def _grads(nets, state) -> dict:
    """{net: {name: gradient}} of the first step, f64 on the CPU: beta1 = 0
    under TTUR, so a parameter's Adam first moment after its first update
    is the gradient it was given."""
    opts = {"gen": state.opt_g, "corr": state.opt_g, "disc": state.opt_d}
    return {net: {k: opts[net].state[p]["exp_avg"].cpu().double()
                  for k, p in getattr(nets, net).named_parameters()}
            for net in TRAINED}


def _rel_l2(got: dict, want: dict, base: dict = None) -> float:
    """||got - want|| / ||want - base|| over all leaves of one network."""
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float(((want[k] - (0 if base is None else base[k])) ** 2).sum())
              for k in want)
    return (num / den) ** 0.5


def _check_losses(got, want, tol, what) -> None:
    """Every loss term on the card against the CPU's at rel `tol`, in one
    line: term card/CPU rel."""
    _check(set(got) == set(want), f"{what}: loss terms {sorted(got)}")
    rels = {k: abs(float(got[k]) - float(want[k])) / (abs(float(want[k]))
                                                      + 1e-2)
            for k in sorted(want)}
    _check(max(rels.values()) <= tol,
           f"{what} on the card vs plain on the CPU, every loss at rel <= "
           f"{tol:g}: " + ", ".join(
               f"{k} {float(got[k]):.6g}/{float(want[k]):.6g} {r:.2g}"
               for k, r in rels.items()))


def term_gradients(P, L, nets, batch, keep: bool = False):
    """{(net, loss term): [gradient of each parameter], f64 on the CPU} of
    one train-mode forward as the train step runs it: each G-side term on
    gen and on corr, each D term (on the detached fake) on disc, by its own
    backward pass. With `keep`, also the fake (its graph kept) and the GAN
    term."""
    data = P.preprocess_input(nets.opt, batch, device=nets.device)
    nets.set_train(True)
    try:
        with L.training():
            out = P.generate_fake(nets, data, train=True)
            with torch.no_grad():
                out["ref_features"] = P.vgg_features(nets, data["ref_image"])
                out["real_features"] = P.vgg_features(nets,
                                                      data["real_image"])
            g_losses = P.compute_generator_losses(nets, data, out)
            d_losses = P.compute_discriminator_losses(nets, data,
                                                      out["fake_image"])
    finally:
        nets.set_train(False)
    grads = {}
    for losses, owners in ((g_losses, ("gen", "corr")), (d_losses, ("disc",))):
        for key, loss in losses.items():
            for net in owners:
                ps = list(getattr(nets, net).parameters())
                gs = torch.autograd.grad(loss, ps, retain_graph=True,
                                         allow_unused=True)
                grads[(net, key)] = [
                    torch.zeros(p.shape, dtype=torch.float64) if t is None
                    else t.cpu().double() for p, t in zip(ps, gs)]
    if keep:
        return grads, dict(fake=out["fake_image"], gan=g_losses["GAN"])
    return grads


@contextlib.contextmanager
def leaky_masks(disc):
    """{module name: x > 0} of every LeakyReLU of `disc` on its first call
    inside the block (the G phase's discriminate), on the host."""
    masks, hooks = {}, []

    def record(name):
        def hook(mod, inp, out):
            masks.setdefault(name, (inp[0] > 0).cpu())
        return hook

    for name, m in disc.named_modules():
        if isinstance(m, torch.nn.LeakyReLU):
            hooks.append(m.register_forward_hook(record(name)))
    try:
        yield masks
    finally:
        for h in hooks:
            h.remove()


def gan_term_reference(P, L, ref, fake, masks):
    """The GAN term's input gradient dGAN/dfake and its gradients on gen
    and corr, from the card's own forward: D (from the check's start state,
    in train mode as the step runs it) in f64 on the CPU at the card's
    fake, each LeakyReLU taking the branch the card's took (`masks`, from
    leaky_masks), and that gradient taken back through the CPU's f32
    forward of gen and corr ({net: [gradient of each parameter], f64}).
    The GAN term reaches gen and corr only through the fake, and D is
    piecewise linear: on a draw where a few of D's pre-activations lie
    within the card's f32 rounding of 0 (the nearest 4.8e-7),
    cuDNN's convs put them on the other side from the CPU's and f64's, and
    dGAN/dfake moved by 2.8% with no fault in the port (PERF.md §6; with
    cuDNN off the card's was within 6.4e-7 of f64;
    cocosnet_tpu_torch/tools/gan_term_draw.py reproduces that draw). On the card's fake and
    branches, the reference is the same smooth function the card
    differentiated, so the check holds the card's arithmetic alone."""
    from cocosnet_tpu_torch.losses.gan import gan_loss
    opt, batch = ref["opt"], ref["batch"]
    cpu = P.Pix2PixNets(opt, device="cpu", seed=1)
    for sd, m in zip(ref["start"], cpu.modules()):
        m.load_state_dict(sd)
    data = P.preprocess_input(opt, batch, device="cpu")
    x = fake.detach().cpu().double().requires_grad_()
    cpu.disc.double()

    def branch(mask):
        def hook(mod, inp, out):
            return torch.where(mask, inp[0], mod.negative_slope * inp[0])
        return hook

    hooks = [m.register_forward_hook(branch(masks[name]))
             for name, m in cpu.disc.named_modules()
             if isinstance(m, torch.nn.LeakyReLU)]
    cpu.set_train(True)
    try:
        with L.training():
            pred_fake, _ = P.discriminate(cpu, data["input_semantics"].double(),
                                          x, data["real_image"].double())
            gan = gan_loss(pred_fake, True, for_discriminator=False,
                           gan_mode=opt.gan_mode) * opt.weight_gan
            u = torch.autograd.grad(gan, x)[0]
            out = P.generate_fake(cpu, data, train=True)
            grads = {}
            for net in ("gen", "corr"):
                ps = list(getattr(cpu, net).parameters())
                gs = torch.autograd.grad(out["fake_image"], ps, u.float(),
                                         retain_graph=True, allow_unused=True)
                grads[net] = [torch.zeros(p.shape, dtype=torch.float64)
                              if t is None else t.double()
                              for p, t in zip(ps, gs)]
    finally:
        cpu.set_train(False)
        for h in hooks:
            h.remove()
    return u, grads


def small_train_opt(cfg, **kw):
    """The flagship training configuration at train_reference_check's
    size: 128 x 256, ngf 16, ndf 16, 13 classes, batch 1."""
    return train_opt(cfg, label_nc=12, crop_size=256, load_size=256,
                     aspect_ratio=2.0, batchSize=1, ngf=16, ndf=16, **kw)


def cpu_train_reference(P, L, TS, ST, g, opt, batch) -> dict:
    """The plain versions' side of train_reference_check for `opt` and
    `batch`, on the CPU under the route it is first called on: the weights
    at unit signal scale, each loss term's gradient on each network, then
    one train step (its losses, gradients, parameters and EMA shadows
    before and after, spectral u/v) and a second step's losses. The routes
    of one configuration compute the same function, so their card runs are
    held to one reference."""
    cpu = P.Pix2PixNets(opt, device="cpu", seed=1)
    for net in cpu.modules():
        condition_weights(net, g, "cpu")
    # the forward advances the spectral u/v: every run restarts from here
    start = [{k: v.clone() for k, v in m.state_dict().items()}
             for m in cpu.modules()]
    want_g = term_gradients(P, L, cpu, batch)
    for sd, a in zip(start, cpu.modules()):
        a.load_state_dict(sd)
    ref = dict(opt=opt, batch=batch, start=start, want_g=want_g,
               p0=_params(cpu), lr=TS.lrs_for_epoch(opt, 1))
    cstate = TS.create_train_state(opt, cpu)
    cstep = ST.make_train_step(cpu)
    ref["want"], _ = cstep(cstate, batch, ref["lr"])
    ref["cg"], ref["cp"] = _grads(cpu, cstate), _params(cpu)
    ref["ema"] = {k: v.cpu().double()
                  for k, v in (cstate.ema or {}).items()}
    ref["uv"] = [{k: t.clone() for k, t in m.state_dict().items()
                  if k.endswith(("weight_u", "weight_v"))}
                 for m in cpu.modules()]
    ref["stats"] = [{k: t.clone() for k, t in m.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
                    for m in cpu.modules()]
    ref["want2"], _ = cstep(cstate, batch, ref["lr"])
    return ref


def train_reference_check(P, L, TS, ST, ref, tag, corr_launches, route):
    """The train step's gradients and two f32 train steps on the card (on
    `route`: at match_kernel 1 "kernels" or "library" for the correlation,
    library convs; at match_kernel 3 "kernels", library convs, or a conv
    route, "dw all" or "fused") against the same weights and batch through
    the plain versions on the CPU (ref, from cpu_train_reference), at
    reference_check's size (128 x 256, ngf 16, ndf 16, batch 1: a size
    where the conv gates take some convs, so the conv routes' counters
    move), the correlation kernels launched as `corr_launches` says:
    - each loss term's gradient on each network it trains, at 2e-2
      relative L2: the f32 orders alone move them up to 7e-3 (the
      contextual loss's 1 - cos cancels, and 1/tau = 100 amplifies the
      warp's logit errors), while a wrong backward moves its terms by
      O(1) (F.avg_pool2d's CUDA backward on an NHWC view moved the GAN
      terms by 0.2-0.44);
    then one step:
    - every loss term at rel 2e-3 with |t| + 1e-2 in the denominator, as
      the CPU tests hold a train step against the JAX package;
    - the step's gradient of each network (its Adam first moment: beta1 =
      0 under TTUR) at 2e-2 relative L2;
    - each network's update p1 - p0, and the EMA shadows' move, at 10%
      relative L2 (Adam's first step is near lr * sign(g), so the few
      elements whose gradient lies near eps move by other amounts);
    - every spectral u/v (G's and Corr's advanced once, D's twice) at atol
      2e-5;
    and the second step's losses at rel 2e-2, as the CPU tests hold it."""
    from cocosnet_tpu_torch.tools import ab_dw as AB
    opt, batch, lr = ref["opt"], ref["batch"], ref["lr"]
    gpu = P.Pix2PixNets(opt, device="cuda", seed=1)
    for sd, b in zip(ref["start"], gpu.modules()):
        b.load_state_dict(sd)
    with leaky_masks(gpu.disc) as masks:
        got_g, kept = term_gradients(P, L, gpu, batch, keep=True)
    # the GAN term on gen and corr from the card's own fake and D's
    # branches (see gan_term_reference); every other term against the
    # CPU's forward
    u_card = torch.autograd.grad(kept["gan"], kept["fake"],
                                 retain_graph=True)[0].cpu().double()
    u_ref, gan_g = gan_term_reference(P, L, ref, kept["fake"], masks)
    u_rel = float((u_card - u_ref).norm() / u_ref.norm())
    _check(u_rel <= 2e-2, f"{tag} dGAN/dfake on the card vs D in f64 on the "
           f"CPU at the card's fake and LeakyReLU branches: relative L2 "
           f"{u_rel:.3g} <= 2e-2")
    want_g = dict(ref["want_g"])
    own = {}   # the GAN term against the CPU's own fake: shown, not held
    for net in ("gen", "corr"):
        own[net] = want_g[(net, "GAN")]
        want_g[(net, "GAN")] = gan_g[net]

    def rel_l2(got, want):
        num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
        den = sum(float((b ** 2).sum()) for b in want)
        return (num / den) ** 0.5 if den else (0.0 if num == 0 else 1.0)

    rels = {key: rel_l2(got_g[key], want_g[key]) for key in sorted(want_g)}
    _check(max(rels.values()) <= 2e-2,
           f"{tag} each loss term's gradient on each network, card vs CPU "
           f"(GAN on gen and corr from the card's fake), relative L2 <= "
           f"2e-2: " + ", ".join(
               f"{term}/{net} {r:.2g}" for (net, term), r in rels.items()))
    print(f"     {tag} the GAN term against the CPU's own forward (not "
          f"held: D's branches near 0 follow each side's rounding): "
          + ", ".join(
              f"{net} {rel_l2(got_g[(net, 'GAN')], own[net]):.2g}"
              for net in own), flush=True)
    del got_g, kept
    for sd, b in zip(ref["start"], gpu.modules()):
        b.load_state_dict(sd)
    p0 = ref["p0"]
    gstate = TS.create_train_state(opt, gpu)
    gstep = ST.make_train_step(gpu)
    counted = counted_entries()
    _zero_counts(counted)
    res = []
    records = AB.record_convs(lambda: res.append(gstep(gstate, batch, lr)))
    got = res[0][0]
    torch.cuda.synchronize()
    moved = {k: fn.launches for k, fn in counted.items()}
    want_moved = _launches(**corr_launches, **AB.predicted_launches(records))
    _check(moved == want_moved,
           f"{tag} small train step launched {moved} == {want_moved}, the "
           f"routing's prediction")
    new = {"dw all": ("conv3x3_dw",),
           "fused": ("conv3x3_fused", "conv3x3_fused_backward")}.get(route,
                                                                    ())
    _check(all(moved[k] for k in new), f"{tag}: the route's kernels "
           f"{new} ran")
    _check_losses(got, ref["want"], 2e-3, f"{tag} small train step")

    cg, gg = ref["cg"], _grads(gpu, gstate)
    cp, gp = ref["cp"], _params(gpu)
    for net in TRAINED:
        rel = _rel_l2(gg[net], cg[net])
        _check(rel <= 2e-2, f"{tag} small train step, {net} gradient "
               f"({len(cg[net])} tensors) on the card vs the CPU: relative "
               f"L2 {rel:.3g} <= 2e-2")
        upd = _rel_l2(gp[net], cp[net], p0[net])
        _check(upd <= 0.1, f"{tag} small train step, {net} update p1 - p0: "
               f"relative L2 {upd:.3g} <= 0.1")
    for net in ("gen", "corr") if ref["ema"] else ():
        pre = net + "."
        ce = {k: v for k, v in ref["ema"].items() if k.startswith(pre)}
        ge = {k: gstate.ema[k].cpu().double() for k in ce}
        base = {k: p0[net][k[len(pre):]] for k in ce}
        ema = _rel_l2(ge, ce, base)
        _check(ema <= 0.1, f"{tag} small train step, {net} EMA shadow move: "
               f"relative L2 {ema:.3g} <= 0.1")

    worst, count = 0.0, 0
    for uv, b in zip(ref["uv"], gpu.modules()):
        sb = b.state_dict()
        for k, t in uv.items():
            worst = max(worst, _maxerr(sb[k].cpu(), t))
            count += 1
    _check(count > 0 and worst <= 2e-5,
           f"{tag} spectral u/v after the step ({count} vectors): max err "
           f"{worst:.3g} <= 2e-5")
    # the BatchNorms' running statistics (configuration (a)), each at rel
    # 2e-3 of its own scale
    worst, count = 0.0, 0
    for stats, b in zip(ref["stats"], gpu.modules()):
        sb = b.state_dict()
        for k, t in stats.items():
            scale = max(float(t.abs().max()), 1e-3)
            worst = max(worst, _maxerr(sb[k].cpu(), t) / scale)
            count += 1
    if count:
        _check(worst <= 2e-3, f"{tag} BatchNorm running statistics after "
               f"the step ({count} vectors): max err / scale {worst:.3g} "
               f"<= 2e-3")

    got, _ = gstep(gstate, batch, lr)
    _check_losses(got, ref["want2"], 2e-2, f"{tag} second small train step")


def inference_opt(cfg, match_kernel):
    """The flagship inference configuration (bench.py:31-37) at batch 6."""
    return cfg.test_defaults(
        dataset_mode="ade20k", label_nc=150, contain_dontcare_label=True,
        crop_size=256, load_size=256, batchSize=6, ngf=64,
        use_attention=True, maskmix=True, PONO=True, PONO_C=True,
        warp_mask_losstype="direct", match_kernel=match_kernel,
        isTrain=False)


def forward_conv_table(P, cfg, L, C, g, opt=None, batch=None,
                       tag="mk3 B6", expected=None) -> dict:
    """Every conv3x3.cu shape of one full-width forward (bf16 policy; the
    flagship mk3 B6 forward by default, or `opt` on `batch`), captured by
    tools/ab_dw.record_convs and routed by the gates as nn.layers.conv2d
    routes them: per (B, H, W, Cin, Cout, ring, statistics) the kernel
    against its plain version (phase 2's bf16 tolerances), its count per
    forward, its time, F.pad + F.conv2d's on the same operands and the
    bound, then the totals over the forward (count x time), so that the
    forward's conv3x3.cu time reads shape by shape. The table must cover
    `expected` launches (the flagship's 80 + 20 by default). Returns the
    record of each shape, by its label."""
    import collections
    from cocosnet_tpu_torch.tools import ab_dw as AB
    F = torch.nn.functional
    L.set_compute_dtype(torch.bfloat16)
    opt = opt or inference_opt(cfg, 3)
    nets = P.Pix2PixNets(opt, seed=0)
    condition_weights(nets.corr, g, "cuda")
    condition_weights(nets.gen, g, "cuda")
    if batch is None:
        batch = make_batch(g, 6, 256, 256, opt.semantic_nc)
    data = P.preprocess_input(opt, batch)
    records = AB.record_convs(lambda: P.inference(nets, data))
    L.set_compute_dtype(None)
    del nets, data
    torch.cuda.empty_cache()
    shapes = collections.Counter()
    for r in records:
        xs, ks = r["x_shape"], r["kernel_shape"]
        gate = dict(stride=r["stride"],
                    padding=1 if r["reflect"] else r["padding"])
        if r["onehot"] or r.get("dilation", 1) != 1:
            continue
        stats = bool(r["want_stats"]
                     and L.conv3x3_stats_supported(xs, ks, **gate))
        if stats or (not r["want_stats"]
                     and L.conv3x3_supported(xs, ks, **gate)):
            shapes[tuple(xs) + (ks[3], r["reflect"], stats)] += 1
    print(f"conv3x3.cu shapes of one {tag} forward (bf16; ms per call; "
          "cuDNN = F.pad + F.conv2d):", flush=True)
    print(f"     {'B,H,W,Cin->Cout,ring,stats':>32s} {'count':>5s} "
          f"{'kernel':>8s} {'cuDNN':>8s} {'bound':>8s} {'TFLOP/s':>8s}",
          flush=True)
    tot = collections.Counter()
    table = {}
    for (b, h, w, ci, co, refl, stats), n in sorted(
            shapes.items(), key=lambda kv: -kv[1]):
        x = torch.randn(b, h, w, ci, generator=g).to("cuda", torch.bfloat16)
        k = (torch.randn(3, 3, ci, co, generator=g) * (9 * ci) ** -0.5).to(
            "cuda", torch.bfloat16)
        bias = (torch.randn(co, generator=g) * 0.1).to("cuda")
        label = (f"{b},{h},{w},{ci}->{co}," + ("reflect" if refl else "zero")
                 + (",stats" if stats else ""))
        got = _outs(C._conv3x3_kernel(x, k, bias, refl, None, stats))
        want = _outs(C.conv3x3_plain(x, k, bias, reflect=refl,
                                     want_stats=stats))
        scale = float(want[0].float().abs().max())
        err = _maxerr(got[0], want[0])
        ok = err <= 2.0 ** -7 * scale
        if stats:
            ok = ok and _maxerr(got[1], want[1]) <= 1e-5 * scale and \
                _maxerr(got[2], want[2]) <= 1e-4 * float(want[2].abs().max())
        _check(ok, f"forward shape {label}: out max err {err:.3g} <= "
               f"{2.0 ** -7 * scale:.3g}" + (", mean and var within 1e-5 x "
                                             "scale and 1e-4 x max var"
                                             if stats else ""))
        del got, want
        ms = time_ms(lambda: C._conv3x3_kernel(x, k, bias, refl, None,
                                               stats), runs=10)
        plain_ms = time_ms(lambda: C.conv3x3_plain(
            x, k, bias, reflect=refl, want_stats=stats), runs=3)
        xc = x.permute(0, 3, 1, 2)
        wc = k.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = bias.to(torch.bfloat16)
        if refl:
            lib = lambda: F.conv2d(  # noqa: E731
                F.pad(xc, (1, 1, 1, 1), mode="reflect"), wc, bc)
        else:
            lib = lambda: F.conv2d(xc, wc, bc, padding=1)  # noqa: E731
        lib_ms = time_ms(lib, runs=10)
        flops = conv3x3_flops(b, h, w, ci, co)
        bms, bound_by = bound_ms(_nbytes(x, k, bias) + b * h * w * co * 2,
                                 flops, BF16_FLOP_S)
        tot.update(kernel=n * ms, cudnn=n * lib_ms, bound=n * bms,
                   launches=n)
        table[label] = dict(count=n, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bms,
                            bound_by=bound_by,
                            shape=(b, h, w, ci, co, refl, stats))
        print(f"     {label:>32s} {n:>5d} {ms:>8.3f} {lib_ms:>8.3f} "
              f"{bms:>8.3f} {flops / ms / 1e9:>8.1f}", flush=True)
        del x, k, bias, xc, wc, bc
    torch.cuda.empty_cache()
    if expected is None:
        expected = CONVS["conv3x3_fused"] + CONVS["conv3x3_fused_stats"]
    _check(tot["launches"] == expected,
           f"the table covers the forward's {int(tot['launches'])} == "
           f"{expected} conv3x3.cu launches")
    print(f"     totals over the forward: kernel {tot['kernel']:.2f} ms, "
          f"cuDNN {tot['cudnn']:.2f} ms, bound {tot['bound']:.2f} ms",
          flush=True)
    return table


def flagship_inference(P, cfg, L, g, match_kernel, timed_runs,
                       record=None) -> dict:
    """Phases 4 and 4b: flagship-width inference (batch 6 and batch 1, bf16
    policy, seeded random weights) at `match_kernel`: the launches of one
    forward, the outputs' shapes and ranges, images/s, batch-1 latency,
    peak memory (the phase's own) and profiles (the batch-6 forward's
    device-busy ms into `record`). Returns the launches."""
    L.set_compute_dtype(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    opt = inference_opt(cfg, match_kernel)
    nets = P.Pix2PixNets(opt, seed=0)
    condition_weights(nets.corr, g, "cuda")
    condition_weights(nets.gen, g, "cuda")
    batch = make_batch(g, 6, 256, 256, opt.semantic_nc)
    counted = counted_entries()
    _zero_counts(counted)
    out = P.inference(nets, P.preprocess_input(opt, batch))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    tag = f"match_kernel {match_kernel} flagship"
    print(f"launches in one {tag} forward: {launches}", flush=True)
    expected = INFERENCE_LAUNCHES[match_kernel]
    _check(launches == expected,
           f"every kernel of the path launched as the routing predicts "
           f"{expected}")
    fake = out["fake_image"]
    _check(tuple(fake.shape) == (6, 256, 256, 3)
           and bool(torch.isfinite(fake).all())
           and float(fake.abs().max()) <= 1.0,
           f"fake_image (6, 256, 256, 3) finite in [-1, 1] (std "
           f"{float(fake.std()):.3f})")
    _check(tuple(out["warp_out"].shape) == (6, 256, 256, 3)
           and tuple(out["warp_mask"].shape) == (6, 64, 64, 151)
           and all(bool(torch.isfinite(out[k]).all())
                   for k in ("warp_out", "warp_mask")),
           "warp_out (6, 256, 256, 3) and warp_mask (6, 64, 64, 151) finite")
    wsum = out["warp_mask"].float().sum(-1)
    _check(float((wsum - 1).abs().max()) < 1e-2,
           "warp_mask rows are distributions over the 151 classes")

    data = P.preprocess_input(opt, batch)
    fwd_ms = time_ms(lambda: P.inference(nets, data), runs=timed_runs)
    one = {k: v[:1] for k, v in batch.items()}
    data1 = P.preprocess_input(opt, one)
    lat = []
    for _ in range(timed_runs + 2):
        t = time.perf_counter()
        P.inference(nets, P.preprocess_input(opt, one))
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t))
    lat = sorted(lat[2:])
    fwd1_ms = time_ms(lambda: P.inference(nets, data1), runs=timed_runs)
    print(f"{tag} batch 6: {fwd_ms:.2f} ms per forward, "
          f"{6e3 / fwd_ms:.2f} images/s; batch 1: p50 "
          f"{lat[len(lat) // 2]:.2f} ms end to end with preprocessing "
          f"({fwd1_ms:.2f} ms forward); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    rec = profile_call(lambda: P.inference(nets, data))
    if record is not None and rec is not None:
        record["busy_ms"] = rec["busy_ms"]
    profile_call(lambda: P.inference(nets, data1))
    del nets, out, data, data1
    torch.cuda.empty_cache()
    return launches


# the loss terms of the flagship train step
FLAGSHIP_LOSS_KEYS = {"no_vgg_feat", "GAN", "GAN_Feat", "fm", "perc",
                      "contextual", "mask", "D_Fake", "D_real"}


def flagship_training(P, cfg, TS, ST, g, match_kernel, route, steps,
                      out=None) -> dict:
    """Phases 5, 5b, 5c and 5d: flagship-width training at batch 8 under the
    bf16 policy through make_train_step, at `match_kernel` on `route` (the
    correlation's at match_kernel 1; "kernels", "dw" or "fused" at 3):
    train_path against TRAIN_LAUNCHES (its record into `out`). Returns the
    launches of the counted step, the reflect ring's among them."""
    opt = train_opt(cfg, label_nc=150, crop_size=256, load_size=256,
                    batchSize=8, ngf=64, ndf=64, match_kernel=match_kernel)
    return train_path(
        P, TS, ST, g, opt,
        lambda: make_batch(g, 8, 256, 256, opt.semantic_nc),
        f"match_kernel {match_kernel} flagship training ({route} route)",
        TRAIN_LAUNCHES[(match_kernel, route)], FLAGSHIP_LOSS_KEYS, steps,
        out=out)


def train_path(P, TS, ST, g, opt, draw_batch, tag, expected, loss_keys,
               steps, profile=True, out=None) -> dict:
    """A full-width train step at batch 8 through make_train_step, weights
    at unit signal scale, on the batch draw_batch() draws after them: the
    launches of one step, against `expected` and against the routing's
    prediction from the step's recorded convs (the correlation's part of
    `expected` beside it), the reflect ring's against the routing's
    prediction (ring_launch_check), the loss terms `loss_keys`, finite, two
    warm-up steps, then `steps` timed steps, peak memory and a profile of
    one step. Returns the launches of the counted step, the ring's among
    them (_ring_counts)."""
    from cocosnet_tpu_torch.ops import ring as R
    from cocosnet_tpu_torch.tools import ab_dw as AB
    nets = P.Pix2PixNets(opt, seed=0)
    for net in nets.modules():
        condition_weights(net, g, "cuda")
    state = TS.create_train_state(opt, nets)
    step = ST.make_train_step(nets)
    lr = TS.lrs_for_epoch(opt, 1)
    batch = {k: v.cuda() for k, v in draw_batch().items()}
    torch.cuda.reset_peak_memory_stats()

    def finite(losses):
        return all(bool(torch.isfinite(v)) for v in losses.values())

    counted = counted_entries()
    _zero_counts(counted)
    R.RING_LAUNCHES.clear()
    res = []
    records = AB.record_convs(lambda: res.append(step(state, batch, lr)))
    losses, vis = res[0]
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    print(f"launches in one {tag} step: {launches}", flush=True)
    predicted = _launches(**_attend_part(expected),
                          **AB.predicted_launches(records))
    _check(launches == expected == predicted,
           f"every kernel of the train path launched as TRAIN_LAUNCHES "
           f"states {expected} and the routing predicts from the step's "
           f"{len(records)} convs")
    launches.update(ring_launch_check(records, tag,
                                      recomputes=bool(opt.remat)))
    _check(set(losses) == loss_keys and finite(losses),
           f"{len(loss_keys)} loss terms, all finite: " + ", ".join(
               f"{k} {float(v):.4g}" for k, v in sorted(losses.items())))
    b = opt.batchSize
    _check(tuple(vis["fake_image"].shape) == (b, 256, 256, 3)
           and bool(torch.isfinite(vis["fake_image"]).all()),
           f"fake_image ({b}, 256, 256, 3) finite")
    losses, _ = step(state, batch, lr)          # second warm-up
    _check(finite(losses), "second step's losses finite")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        losses, _ = step(state, batch, lr)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t) / steps
    _check(finite(losses), f"losses finite after {steps + 2} steps")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag} batch {b}: {dt:.4f} s/step, {b / dt:.2f} images/s "
          f"({steps} steps after 2 warm-ups, host clock); peak memory "
          f"{peak:.2f} GiB", flush=True)
    if out is not None:
        out.update(s_per_step=dt, images_per_s=b / dt, peak_gib=peak)
    if profile:     # the timed steps warmed it up
        rec = profile_call(lambda: step(state, batch, lr), warmup=False)
        if out is not None and rec is not None:
            out["busy_ms"] = rec["busy_ms"]
    del nets, state, step, batch, losses, vis
    torch.cuda.empty_cache()
    return launches


def entry_twins(L) -> None:
    """Phase 7: the two command-line twins, in-process, at flagship width
    (256 px, ngf 64, ndf 64, 151 classes, bf16 policy) on a synthetic
    ADE20k tree made from a seed (24 training and 12 validation photos at
    384 x 288, so the resize and the random crop run):
    - the train twin (cli/train.py) with bench.py's training flags at batch
      8 for one epoch, then under --D_steps_per_G 2: finite losses,
      state_latest/ and state_1/ written, the shift9 kernels launched once
      per G step and on no D-only step (--continue_train: phase 15 (c));
    - the test twin (cli/test.py) at batch 6 on the first run's nets
      with weights at unit signal scale, saved as state_cond/: its weights
      bit for bit the saved ones, the grids written, each forward kernel
      launched its per-forward count times the batches, and the first
      batch's fake_image, whose std is above 0.05, equal to
      make_inference_step on the same batch and nets within 1e-6;
    printing the train twin's s/step and the test twin's images/s with the
    host pipeline."""
    import shutil
    import statistics
    import tempfile
    from cocosnet_tpu_torch.cli import test as TTEST
    from cocosnet_tpu_torch.cli import train as TTRAIN
    from cocosnet_tpu_torch.data import synthetic as SYN
    from cocosnet_tpu_torch.data.loader import create_dataloader, to_device
    from cocosnet_tpu_torch.train import checkpoints as CK
    from cocosnet_tpu_torch.train.steps import make_inference_step
    base = tempfile.mkdtemp(prefix="cocosnet_twins_")
    try:
        root = os.path.join(base, "ade")
        SYN.make_ade20k_tree(root, n_train=24, n_val=12)
        print(f"phase 7 works under {base}: "
              f"{shutil.disk_usage(base).free / 2**30:.0f} GiB free",
              flush=True)
        ck = os.path.join(base, "checkpoints")
        flags = ["--dataset_mode", "ade20k", "--dataroot", root,
                 "--use_attention", "--maskmix", "--warp_mask_losstype",
                 "direct", "--PONO", "--PONO_C", "--checkpoints_dir", ck,
                 "--output_dir", os.path.join(base, "output"),
                 "--nThreads", "4"]
        train_flags = flags + [
            "--batchSize", "8", "--niter", "1", "--niter_decay", "0",
            "--weight_mask", "100.0", "--use_ema", "--vgg_normal_correct",
            "--save_epoch_freq", "1", "--print_freq", "8",
            "--display_freq", "16"]
        counted = counted_entries()
        per_step = TRAIN_LAUNCHES[(3, "kernels")]
        runs, step_s = {}, []
        # (--continue_train: phase 15 (c), since phase 15 came: the
        # script's time)
        for name, extra in (("twin", []),
                            ("twin_d2", ["--D_steps_per_G", "2"])):
            _zero_counts(counted)
            run = TTRAIN.main(train_flags + ["--name", name.split()[0]]
                              + extra)
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counted.items()}
            want = {k: n * run.g_steps for k, n in per_step.items()}
            print(f"train twin {name}: {run.g_steps} G steps, "
                  f"{run.d_steps} D-only steps, launches {launches}",
                  flush=True)
            _check(launches == want and run.g_steps == (2 if extra[:1] == [
                "--D_steps_per_G"] else 3) and run.d_steps == (
                    1 if extra[:1] == ["--D_steps_per_G"] else 0),
                   f"train twin {name}: the shift9 kernels once per G step "
                   f"and on no D-only step ({want})")
            _check(all(map(lambda v: v == v and abs(v) < float("inf"),
                           run.losses.values())),
                   f"train twin {name}: last losses finite: " + ", ".join(
                       f"{k} {v:.4g}" for k, v in sorted(run.losses.items())))
            step_s += run.step_seconds[1:]
            runs[name] = run
            # each state_<label>/ holds every net, the EMA shadows and both
            # Adam states: 2.6 GB at this width
            run_dir = os.path.join(ck, name)
            files = set(os.listdir(os.path.join(run_dir, "state_latest"))) \
                & set(os.listdir(os.path.join(run_dir, "state_1")))
            _check(files == {*CK.NET_FILES.values(), *CK.EMA_FILES.values(),
                             CK.OPTIMIZER_FILE},
                   f"train twin {name}: state_latest/ and state_1/ hold "
                   f"{sorted(files)}")
            if name == "twin_d2":
                shutil.rmtree(run_dir)
        print(f"train twin batch 8: {statistics.median(step_s):.4f} s/step "
              f"(median of {len(step_s)} steps after each run's first, G "
              f"and D-only; host clock over the loop, the wait for the "
              f"loader included, to the losses on the host)", flush=True)

        # the test twin reads weights at unit signal scale (6 steps from
        # the init the fakes are near flat), saved by the port as
        # state_cond/
        trained = runs["twin"].nets
        g = torch.Generator().manual_seed(7)
        condition_weights(trained.corr, g, "cuda")
        condition_weights(trained.gen, g, "cuda")
        CK.save_state(trained.opt, runs["twin"].state, trained, "cond")
        _zero_counts(counted)
        test = TTEST.main(flags + ["--name", "twin", "--batchSize", "6",
                                   "--which_epoch", "cond"])
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counted.items()}
        want = {k: n * test.batches
                for k, n in INFERENCE_LAUNCHES[3].items()}
        print(f"test twin: {test.batches} batches, launches {launches}",
              flush=True)
        _check(test.batches == 2 and test.images == 12 and launches == want,
               f"test twin: 12 images in 2 batches of 6, each forward "
               f"kernel launched its count times the batches {want}")
        saved = os.path.join(ck, "twin", "state_cond")
        for net, fname in (("gen", "net_G.pth"), ("corr", "net_Corr.pth")):
            disk = torch.load(os.path.join(saved, fname), map_location="cpu",
                              weights_only=True)
            got = getattr(test.nets, net).state_dict()
            live = getattr(trained, net).state_dict()
            _check(got.keys() == disk.keys() == live.keys() and all(
                torch.equal(got[k].cpu(), disk[k])
                and torch.equal(got[k], live[k]) for k in got),
                f"test twin's {net}: {len(got)} tensors bit for bit the "
                f"saved {fname} and the live conditioned weights")
        for i in range(test.batches):
            size = PILImage.open(os.path.join(
                base, "output", "test", "twin", f"{i}.png")).size
            _check(size == (6 * 256, 3 * 256),
                   f"test twin grid {i}.png {size} (label, exemplar and "
                   f"output rows of 6)")
        arrays, _ = to_device(test.first_batch, test.nets.device)
        again = make_inference_step(test.nets)(arrays)["fake_image"]
        err = float((again.float().cpu()
                     - torch.from_numpy(test.first_fake)).abs().max())
        std = float(test.first_fake.std())
        _check(tuple(again.shape) == (6, 256, 256, 3) and err <= 1e-6
               and bool(torch.isfinite(again).all()) and std > 0.05,
               f"test twin's first fake_image vs make_inference_step on the "
               f"same batch and nets: max err {err:.3g} <= 1e-6; the "
               f"output carries signal (std {std:.3f} > 0.05)")
        print(f"test twin batch 6: {test.images / test.seconds:.2f} images/s "
              f"including the host pipeline ({test.images} images in "
              f"{test.seconds:.2f} s, the first batch included)", flush=True)
        # its parts: the loader alone (decode, transforms, pairing on the
        # host), and the step alone on the first batch, already on the card
        t = time.perf_counter()
        n = sum(len(b["path"]) for b in create_dataloader(test.nets.opt))
        load_s = time.perf_counter() - t
        step = make_inference_step(test.nets)
        fwd_ms = time_ms(lambda: step(arrays), runs=5)
        print(f"test twin's parts: the loader alone {n / load_s:.2f} "
              f"images/s ({n} images in {load_s:.3f} s); "
              f"make_inference_step at batch 6 {6e3 / fwd_ms:.2f} images/s "
              f"({fwd_ms:.2f} ms a batch, CUDA events, 5 runs); the rest of "
              f"the twin's time is the copies, the fake's trip to the host "
              f"and the PNG grids", flush=True)
    finally:
        L.set_compute_dtype(None)
        shutil.rmtree(base, ignore_errors=True)


SERVE_FLAGS = ["--dataset_mode", "ade20k", "--use_attention", "--maskmix",
               "--warp_mask_losstype", "direct", "--PONO", "--PONO_C",
               "--nThreads", "4"]


def serve_graphs(P, cfg, L, g) -> dict:
    """Phase 8, first part: tools/serve.make_serve_step at flagship width
    (bf16 policy, weights at unit signal scale) at match_kernel 3 batch 6
    and 1, and at match_kernel 1 batch 6: the kernels launched on the
    capture call as often as in one eager forward (INFERENCE_LAUNCHES), and
    the replayed graph's uint8 output the eager forward's bits, quantized
    the same way, on two batches after one capture; at match_kernel 3, the
    graph's and the eager forward's CUDA-event ms and profiles. Returns the
    capture calls' launches by (match_kernel, batch) and the mk3 nets."""
    from cocosnet_tpu_torch.ops import ring as R
    from cocosnet_tpu_torch.tools import serve as SV
    from cocosnet_tpu_torch.train.steps import make_inference_step
    L.set_compute_dtype(torch.bfloat16)
    counted = counted_entries()
    captures, kept = {}, None
    for mk in (3, 1):
        opt = inference_opt(cfg, mk)
        nets = P.Pix2PixNets(opt, seed=0)
        condition_weights(nets.corr, g, "cuda")
        condition_weights(nets.gen, g, "cuda")
        infer = make_inference_step(nets)

        def eager(batch):
            return SV.quantize(infer(batch)["fake_image"])

        for b in ((6, 1) if mk == 3 else (6,)):
            tag = f"serve graph mk{mk} B{b}"
            batches = [{k: v.cuda() for k, v in make_batch(
                g, b, 256, 256, opt.semantic_nc).items()} for _ in range(2)]
            _zero_counts(counted)
            R.RING_LAUNCHES.clear()
            want = eager(batches[0])
            torch.cuda.synchronize()
            forward = {k: fn.launches for k, fn in counted.items()}
            ring = {k: _ring_counts()[k] for k in RING_ENTRIES}
            want = [want, eager(batches[1])]
            step = SV.make_serve_step(nets, b)
            step.warm_up()
            _zero_counts(counted)
            R.RING_LAUNCHES.clear()
            step.capture()
            torch.cuda.synchronize()
            captures[(mk, b)] = {k: fn.launches for k, fn in counted.items()}
            _check(captures[(mk, b)] == forward == INFERENCE_LAUNCHES[mk],
                   f"{tag}: the capture call launched {captures[(mk, b)]}, "
                   f"one eager forward's launches")
            # the small maps' reflect convs (W < 32) take the library
            # route, their ring built by ops/ring's forward kernel
            captures[(mk, b)].update(
                {k: _ring_counts()[k] for k in RING_ENTRIES})
            _check(ring == {k: captures[(mk, b)][k] for k in RING_ENTRIES}
                   and ring["reflect_ring"] > 0
                   and ring["reflect_ring_backward"] == 0,
                   f"{tag}: the reflect ring launched {ring} in the eager "
                   f"forward and on the capture call, forward only")
            for i, batch in enumerate(batches):
                got = step(batch).clone()
                diff = int((got.int() - want[i].int()).abs().max())
                std = float(got.float().std())
                _check(got.dtype == torch.uint8 and tuple(got.shape) == (
                    b, 256, 256, 3) and torch.equal(got, want[i])
                    and std > 10,
                    f"{tag}: replay {i + 1} after one capture has the eager "
                    f"forward's bits (max level diff {diff}; std {std:.1f} "
                    f"levels)")
            _check(all(fn.launches == captures[(mk, b)][k]
                       for k, fn in counted.items())
                   and _ring_counts()["reflect_ring"]
                   == captures[(mk, b)]["reflect_ring"],
                   f"{tag}: the replays ran no kernel wrapper")
            if mk == 3:
                graph_ms = time_ms(lambda: step(batches[0]), runs=10)
                eager_ms = time_ms(lambda: eager(batches[0]), runs=10)
                print(f"{tag}: graph {graph_ms:.2f} ms, eager {eager_ms:.2f} "
                      f"ms per forward (CUDA events, 10 runs; "
                      f"{b * 1e3 / graph_ms:.2f} vs "
                      f"{b * 1e3 / eager_ms:.2f} images/s)", flush=True)
                print(f"{tag}, graph replay:", flush=True)
                profile_call(lambda: step(batches[0]))
                print(f"{tag}, eager forward:", flush=True)
                profile_call(lambda: eager(batches[0]))
            del step, batches, want
            torch.cuda.empty_cache()
        if mk == 3:
            kept = nets
        del nets, infer
        torch.cuda.empty_cache()
    L.set_compute_dtype(None)
    return captures, kept


def served_files(L, nets, base) -> None:
    """Phase 8, second part: the serve twin in-process (--once, batch 6,
    npy) on 8 requests of a synthetic ADE20k tree, from nets' weights
    saved as the reference's flat latest_net_{G,Corr}.pth; every served
    file holds the bits of nets' eager forward, quantized as serve.py
    does, on the batches the server dispatched, rebuilt through the same
    pipeline."""
    import numpy as np
    from cocosnet_tpu_torch.cli import common
    from cocosnet_tpu_torch.data import transforms as T
    from cocosnet_tpu_torch.tools import serve as SV
    from cocosnet_tpu_torch.train.steps import make_inference_step
    ck = os.path.join(base, "checkpoints", "serve")
    os.makedirs(ck)
    torch.save(nets.gen.state_dict(), os.path.join(ck, "latest_net_G.pth"))
    torch.save(nets.corr.state_dict(),
               os.path.join(ck, "latest_net_Corr.pth"))
    train = os.path.join(base, "ade", "training")
    watch, out = os.path.join(base, "in"), os.path.join(base, "out")
    os.makedirs(watch)
    stems = sorted(f[:-4] for f in os.listdir(train) if f.endswith(".jpg"))
    for i in range(8):
        a, b = stems[i], stems[i + 1]
        for src, dst in ((a + ".png", ".label.png"),
                         (b + ".png", ".ref_label.png"),
                         (b + ".jpg", ".ref.jpg")):
            with open(os.path.join(train, src), "rb") as f:
                data = f.read()
            with open(os.path.join(watch, f"r{i}{dst}"), "wb") as f:
                f.write(data)
    run = SV.main(SERVE_FLAGS + [
        "--watch_dir", watch, "--out_dir", out, "--once", "--poll_s",
        "0.05", "--out_format", "npy", "--batchSize", "6",
        "--checkpoints_dir", os.path.dirname(ck), "--name", "serve"])
    torch.cuda.synchronize()
    _check(run.served == 8 and run.failed == 0,
           f"serve twin --once: 8 requests served in {len(run.batches)} "
           f"batches {run.batches}")
    opt = nets.opt
    common.set_numerics(opt)    # the policy the server ran under
    pipeline = SV.make_label_pipeline(opt)
    infer = make_inference_step(nets)
    for reqs in run.batches:
        batch = SV.zero_batch(opt, 6)
        for j, r in enumerate(reqs):
            rl, params = SV.label_tensor(
                pipeline, os.path.join(watch, r + ".ref_label.png"))
            batch["label"][j] = SV.label_tensor(
                pipeline, os.path.join(watch, r + ".label.png"))[0]
            batch["label_ref"][j] = rl
            batch["ref"][j] = T.image_to_tensor(opt, PILImage.open(
                os.path.join(watch, r + ".ref.jpg")).convert("RGB"), params)
        want = SV.quantize(infer(batch)["fake_image"]).cpu().numpy()
        for j, r in enumerate(reqs):
            got = np.load(os.path.join(out, r + ".npy"))
            _check(got.dtype == np.uint8 and got.shape == want[j].shape
                   and np.array_equal(got, want[j]),
                   f"served {r}.npy (slot {j}) has the bits of the eager "
                   f"step's quantized output (std {got.std():.1f} levels)")
    L.set_compute_dtype(None)


def serve_load(base) -> None:
    """Phase 8, third part: tools/bench_serve against the serve twin as a
    subprocess on the card, from the weights of served_files: 240
    requests at batch 6 all at once with npy and with png results, then
    100 at batch 1 at 10 requests/s (480 and 200 before phase 15 came:
    the script's time); prints each JSON line."""
    from cocosnet_tpu_torch.tools import bench_serve as BS
    src = os.path.join(base, "ade", "training")
    serve = SERVE_FLAGS + ["--checkpoints_dir",
                           os.path.join(base, "checkpoints"), "--name",
                           "serve"]
    for what, bench, extra in (
            ("batch 6, all at once, npy", ["--n_requests", "240",
                                           "--warmup", "6"],
             ["--batchSize", "6", "--out_format", "npy"]),
            ("batch 6, all at once, png", ["--n_requests", "240",
                                           "--warmup", "6"],
             ["--batchSize", "6", "--out_format", "png"]),
            ("batch 1 at 10 requests/s, png", ["--n_requests", "100",
                                               "--warmup", "2",
                                               "--arrival_rate", "10"],
             ["--batchSize", "1", "--out_format", "png"])):
        t = time.perf_counter()
        res = BS.main(["--src_dir", src, "--timeout_s", "240"] + bench
                      + ["--"] + serve + extra)
        lat = res["latency_ms"]
        _check(res["throughput_rps"] > 0 and 0 < lat["p50"] <= lat["p99"],
               f"bench_serve {what}: {res['throughput_rps']} requests/s, "
               f"p50 {lat['p50']} ms, p99 {lat['p99']} ms (the run "
               f"{time.perf_counter() - t:.1f} s with the server's start)")


def serving(P, cfg, L, g) -> dict:
    """Phase 8: the serving path on the card (serve_graphs, served_files,
    serve_load) on a synthetic ADE20k tree made from a seed (240 photos
    of 384 x 288: bench_serve's 240 requests at batch 6 take each photo
    once, so no request finds its photos in the serve twin's preprocess
    cache). Returns the capture calls' launches by (match_kernel,
    batch)."""
    import shutil
    import tempfile
    from cocosnet_tpu_torch.data import synthetic as SYN
    base = tempfile.mkdtemp(prefix="cocosnet_serve_")
    try:
        SYN.make_ade20k_tree(os.path.join(base, "ade"), n_train=240,
                             n_val=1)
        captures, nets = serve_graphs(P, cfg, L, g)
        served_files(L, nets, base)
        del nets
        torch.cuda.empty_cache()
        serve_load(base)
    finally:
        L.set_compute_dtype(None)
        shutil.rmtree(base, ignore_errors=True)
    return captures


# ------------------------------------------------------------------ phase 9

# the three other published inference configurations (BASELINE.json's
# configs): each dataset's defaults (config.py) and the flags beyond them,
# with the flagship's --use_attention --PONO --PONO_C, at batch 4, the
# reference README's inference batch for these datasets
PUBLISHED = {
    "celebahq": dict(dataset_mode="celebahq", label_nc=19,
                     contain_dontcare_label=False, maskmix=True,
                     warp_mask_losstype="direct", warp_bilinear=True),
    "celebahqedge": dict(dataset_mode="celebahqedge", label_nc=15,
                         contain_dontcare_label=False),
    "deepfashion": dict(dataset_mode="deepfashion", label_nc=20,
                        contain_dontcare_label=False, warp_bilinear=True,
                        no_flip=True, warp_patch=True, video_like=True),
}
PUBLISHED_COMMON = dict(use_attention=True, PONO=True, PONO_C=True,
                        adaptor_kernel=4)
# the command-line form of each configuration's model flags
PUBLISHED_ARGV = {
    "celebahq": ["--use_attention", "--maskmix", "--warp_mask_losstype",
                 "direct", "--PONO", "--PONO_C", "--warp_bilinear",
                 "--adaptor_kernel", "4"],
    "celebahqedge": ["--use_attention", "--PONO", "--PONO_C",
                     "--adaptor_kernel", "4"],
}
# the values D of each warp: 3 colours + 19 mask columns, 3 colours, the
# 3 x 4 x 4 values of a patch
WARP_D = {"celebahq": 22, "celebahqedge": 3, "deepfashion": 48}
CONFIG_BATCH = 4


def config_opt(cfg, mode, **kw):
    """A published configuration at full width (256 px, ngf 64) and batch
    4, or with the keywords given."""
    return cfg.test_defaults(**{
        **PUBLISHED_COMMON, **PUBLISHED[mode], "crop_size": 256,
        "load_size": 256, "batchSize": CONFIG_BATCH, "ngf": 64,
        "isTrain": False, **kw})


def config_batch(g, mode, b, h, w, nc):
    """A loader batch of `mode` from generator g: celebahq's class ids
    interleaved with a 0/1 glasses mask; the edge and pose modes' dense
    channels in [0, 1], seeded (deepfashion's pose rendering needs OpenCV,
    which the card's machine may lack)."""
    def label():
        if mode == "celebahq":
            return torch.cat([
                torch.randint(0, nc, (b, h, w, 1), generator=g).float(),
                (torch.rand(b, h, w, 1, generator=g) < 0.3).float()], -1)
        return torch.rand(b, h, w, nc, generator=g)

    return {"label": label(),
            "image": torch.rand(b, h, w, 3, generator=g) * 2 - 1,
            "ref": torch.rand(b, h, w, 3, generator=g) * 2 - 1,
            "label_ref": label(), "self_ref": torch.ones(b)}


def _config_keys(mode):
    return ("fake_image", "warp_out", "adaptive_feature_seg",
            "adaptive_feature_img") + (("warp_mask",) if mode == "celebahq"
                                       else ())


def config_reference_check(P, cfg, g, mode) -> None:
    """Phase 3's check for a published configuration: the slice on the
    card (kernels, f32) against the same weights and batch through the
    plain versions on the CPU at a small input (128 x 256, ngf 16), the
    launches those the routing predicts (shift9 once, the one-hot conv
    never, both dense conv kernels among them), every output at atol
    5e-4."""
    from cocosnet_tpu_torch.tools import ab_dw as AB
    opt = config_opt(cfg, mode, aspect_ratio=2.0, batchSize=1, ngf=16)
    batch = config_batch(g, mode, 1, 128, 256, opt.semantic_nc)
    cpu = P.Pix2PixNets(opt, device="cpu", seed=1)
    condition_weights(cpu.corr, g, "cpu")
    condition_weights(cpu.gen, g, "cpu")
    gpu = P.Pix2PixNets(opt, device="cuda", seed=1)
    gpu.corr.load_state_dict(cpu.corr.state_dict())
    gpu.gen.load_state_dict(cpu.gen.state_dict())
    want = P.inference(cpu, P.preprocess_input(opt, batch, device="cpu"))
    counted = counted_entries()
    _zero_counts(counted)
    res = []
    records = AB.record_convs(lambda: res.append(P.inference(
        gpu, P.preprocess_input(opt, batch, device="cuda"))))
    got = res[0]
    moved = {k: fn.launches for k, fn in counted.items()}
    predicted = _launches(attend_shift9=1, **AB.predicted_launches(records))
    _check(moved == predicted and predicted["conv3x3_onehot"] == 0 and all(
        moved[k] for k in ("conv3x3_fused", "conv3x3_fused_stats")),
        f"{mode} small input launched {moved} == {predicted}, the "
        f"routing's prediction: shift9 once, the one-hot conv never, both "
        f"dense conv kernels")
    errs = {k: _maxerr(got[k].cpu(), want[k]) for k in _config_keys(mode)}
    _check(all(e <= 5e-4 for e in errs.values()),
           f"{mode} small-input slice on the card vs plain on the CPU: max "
           "err " + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
           + " <= 5e-4")


def config_forward(P, cfg, L, g, mode) -> dict:
    """A published configuration at full width, batch 4, bf16 policy,
    weights at unit signal scale: one eager forward through
    preprocess_input and inference (its launches the routing's prediction
    from the convs it recorded: shift9 once, the one-hot conv never; its
    outputs' shapes and ranges), its ms, peak memory and profile; then
    tools/serve.make_serve_step's CUDA graph at batch 4 (the capture call's
    launches the eager forward's, two replays with the eager forward's
    bits) and its ms and profile. Returns the launches of the forward and
    of the capture call, and the batch."""
    from cocosnet_tpu_torch.tools import ab_dw as AB
    from cocosnet_tpu_torch.tools import serve as SV
    from cocosnet_tpu_torch.train.steps import make_inference_step
    L.set_compute_dtype(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    b = CONFIG_BATCH
    opt = config_opt(cfg, mode)
    nets = P.Pix2PixNets(opt, seed=0)
    condition_weights(nets.corr, g, "cuda")
    condition_weights(nets.gen, g, "cuda")
    batches = [{k: v.cuda() for k, v in config_batch(
        g, mode, b, 256, 256, opt.semantic_nc).items()} for _ in range(2)]
    counted = counted_entries()
    _zero_counts(counted)
    res = []
    records = AB.record_convs(lambda: res.append(P.inference(
        nets, P.preprocess_input(opt, batches[0]))))
    torch.cuda.synchronize()
    out = res.pop()
    launches = {k: fn.launches for k, fn in counted.items()}
    predicted = _launches(attend_shift9=1, **AB.predicted_launches(records))
    tag = f"{mode} B{b}"
    _check(launches == predicted and launches["conv3x3_onehot"] == 0,
           f"{tag} forward launched {launches} == {predicted}, the "
           f"routing's prediction (shift9 once, the one-hot conv never)")
    fake = out["fake_image"]
    _check(tuple(fake.shape) == (b, 256, 256, 3)
           and bool(torch.isfinite(fake).all())
           and float(fake.abs().max()) <= 1.0
           and tuple(out["warp_out"].shape) == (b, 256, 256, 3)
           and bool(torch.isfinite(out["warp_out"]).all()),
           f"{tag}: fake_image and warp_out ({b}, 256, 256, 3) finite, the "
           f"fake in [-1, 1] (std {float(fake.std()):.3f})")
    if mode == "celebahq":
        # convex combinations of the exemplar's 0/1 semantics (the glasses
        # at slot -3 make a row's sum 0, 1 or 2)
        wm = out["warp_mask"].float()
        _check(tuple(wm.shape) == (b, 64, 64, 19)
               and bool(torch.isfinite(wm).all())
               and float(wm.min()) >= -1e-3 and float(wm.max()) <= 1 + 1e-3,
               f"{tag}: warp_mask ({b}, 64, 64, 19) finite in [0, 1]")
    del out, res
    data = P.preprocess_input(opt, batches[0])
    fwd_ms = time_ms(lambda: P.inference(nets, data), runs=10)
    print(f"{tag} eager: {fwd_ms:.2f} ms per forward ({b * 1e3 / fwd_ms:.2f} "
          f"images/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"{tag}, eager forward:", flush=True)
    profile_call(lambda: P.inference(nets, data))
    del data

    infer = make_inference_step(nets)

    def eager(batch):
        return SV.quantize(infer(batch)["fake_image"])

    want = [eager(x) for x in batches]
    step = SV.make_serve_step(nets, b)
    step.warm_up()
    _zero_counts(counted)
    step.capture()
    torch.cuda.synchronize()
    capture = {k: fn.launches for k, fn in counted.items()}
    _check(capture == launches,
           f"{tag} serve graph: the capture call launched {capture}, the "
           f"eager forward's launches")
    for i, batch in enumerate(batches):
        got = step(batch).clone()
        diff = int((got.int() - want[i].int()).abs().max())
        _check(torch.equal(got, want[i]) and float(got.float().std()) > 10,
               f"{tag} serve graph: replay {i + 1} has the eager forward's "
               f"bits (max level diff {diff})")
    graph_ms = time_ms(lambda: step(batches[0]), runs=10)
    print(f"{tag} serve graph: {graph_ms:.2f} ms per forward "
          f"({b * 1e3 / graph_ms:.2f} images/s) vs eager {fwd_ms:.2f} ms",
          flush=True)
    print(f"{tag}, graph replay:", flush=True)
    profile_call(lambda: step(batches[0]))
    del step, nets, infer, want
    torch.cuda.empty_cache()
    L.set_compute_dtype(None)
    return dict(launches=launches, capture=capture, opt=opt,
                batch={k: v.cpu() for k, v in batches[0].items()})


def config_conv_row(C, g, record) -> dict:
    """A conv table record with the plain version's time on its shape."""
    b, h, w, ci, co, refl, stats = record["shape"]
    x = torch.randn(b, h, w, ci, generator=g).to("cuda", torch.bfloat16)
    k = (torch.randn(3, 3, ci, co, generator=g) * (9 * ci) ** -0.5).to(
        "cuda", torch.bfloat16)
    bias = (torch.randn(co, generator=g) * 0.1).to("cuda")
    plain_ms = time_ms(lambda: C.conv3x3_plain(x, k, bias, reflect=refl,
                                               want_stats=stats), runs=3)
    del x, k, bias
    torch.cuda.empty_cache()
    return {k: v for k, v in record.items() if k not in ("count", "shape")} \
        | dict(plain_ms=plain_ms)


def config_test_twin(P, cfg, L, g, mode, base) -> None:
    """The test twin (cli/test.py) at full width and batch 4 on a
    synthetic CelebA-HQ tree (data/synthetic.make_celebahq_tree: 8
    validation photos of 288 x 288, so the resize runs) with weights at
    unit signal scale saved as the reference's flat cond_net_{G,Corr}.pth:
    8 images in 2 batches, shift9 once a batch and the one-hot conv never,
    the grids written, the first batch's fake_image equal to
    make_inference_step's within 1e-6 and not flat; prints images/s with
    the host pipeline."""
    from cocosnet_tpu_torch.cli import test as TTEST
    from cocosnet_tpu_torch.data import synthetic as SYN
    from cocosnet_tpu_torch.data.loader import to_device
    from cocosnet_tpu_torch.train.steps import make_inference_step
    root, tables = os.path.join(base, "celeb"), os.path.join(base, "tables")
    if not os.path.isdir(root):
        SYN.make_celebahq_tree(root, n_train=4, n_val=8, size=288,
                               block=32, table_dir=tables)
    ck = os.path.join(base, "checkpoints")
    nets = P.Pix2PixNets(config_opt(cfg, mode), seed=0)
    condition_weights(nets.corr, g, "cuda")
    condition_weights(nets.gen, g, "cuda")
    os.makedirs(os.path.join(ck, mode), exist_ok=True)
    for net, fname in (("gen", "G"), ("corr", "Corr")):
        torch.save(getattr(nets, net).state_dict(),
                   os.path.join(ck, mode, f"cond_net_{fname}.pth"))
    del nets
    torch.cuda.empty_cache()
    counted = counted_entries()
    _zero_counts(counted)
    out = os.path.join(base, "output")
    try:
        # the twin sets the process's bf16 policy (--compute_dtype bf16)
        run = TTEST.main(["--dataset_mode", mode, "--dataroot", root,
                          "--ref_table_dir", tables, "--batchSize",
                          str(CONFIG_BATCH), "--crop_size", "256",
                          "--load_size", "256", "--nThreads", "4",
                          "--checkpoints_dir", ck, "--name", mode,
                          "--which_epoch", "cond", "--output_dir", out]
                         + PUBLISHED_ARGV[mode])
        torch.cuda.synchronize()
    finally:
        L.set_compute_dtype(None)
    launches = {k: fn.launches for k, fn in counted.items()}
    _check(run.images == 8 and run.batches == 2
           and launches["attend_shift9"] == 2
           and launches["conv3x3_onehot"] == 0,
           f"{mode} test twin: 8 images in 2 batches, launches {launches}")
    for i in range(run.batches):
        size = PILImage.open(os.path.join(out, "test", mode,
                                          f"{i}.png")).size
        _check(size == (CONFIG_BATCH * 256, 3 * 256),
               f"{mode} test twin grid {i}.png {size}")
    arrays, _ = to_device(run.first_batch, run.nets.device)
    L.set_compute_dtype(torch.bfloat16)
    again = make_inference_step(run.nets)(arrays)["fake_image"]
    L.set_compute_dtype(None)
    err = float((again.float().cpu()
                 - torch.from_numpy(run.first_fake)).abs().max())
    std = float(run.first_fake.std())
    _check(err <= 1e-6 and std > 0.05,
           f"{mode} test twin: the first batch's fake_image is "
           f"make_inference_step's (max err {err:.3g} <= 1e-6), std "
           f"{std:.3f} > 0.05")
    print(f"{mode} test twin: {run.images / run.seconds:.2f} images/s with "
          f"the host pipeline ({run.images} images, {run.seconds:.2f} s)",
          flush=True)
    del run, again
    torch.cuda.empty_cache()


def published_configs(P, cfg, L, C, S, g) -> list:
    """Phase 9: celebahq, celebahqedge and deepfashion on the card, each
    at full width and batch 4: the small-input slice against the CPU, the
    shift9 forward at the configuration's warp width D against its plain
    version (timed beside SDPA), the eager forward and the serve graph
    (config_forward), every conv3x3.cu shape of its forward (the table of
    phase 2), and for the two CelebA-HQ modes the test twin on a synthetic
    tree. Returns the kernels line's rows of the phase: the shift9
    forward at each D and the residual stack's statistics conv."""
    import shutil
    import tempfile
    rows = []
    base = tempfile.mkdtemp(prefix="cocosnet_configs_")
    # (on the H100 the per-launch device times of these checks have read
    # "not measured" or missed the flash launch, while profile_call's
    # sessions in this phase saw it: PERF.md, open questions)
    shifts = {mode: check_shift9(S, g, pono_c=True, b=CONFIG_BATCH,
                                 d=WARP_D[mode]) for mode in PUBLISHED}
    try:
        for mode in PUBLISHED:
            config_reference_check(P, cfg, g, mode)
            run = config_forward(P, cfg, L, g, mode)
            opt, launches = run["opt"], run["launches"]
            table = forward_conv_table(
                P, cfg, L, C, g, opt=opt, batch=run["batch"],
                tag=f"{mode} B{CONFIG_BATCH}",
                expected=launches["conv3x3_fused"]
                + launches["conv3x3_fused_stats"])
            path = f"{mode} inference"
            rows.append(dict(
                name=f"attend_shift9 D{WARP_D[mode]}", path=path,
                launches=launches["attend_shift9"],
                serve_launches=run["capture"]["attend_shift9"],
                **shifts[mode]))
            stack = 4 * 64 + (opt.semantic_nc if opt.maskmix else 0)
            label = next(lb for lb, r in table.items()
                         if r["shape"][3:] == (stack, stack, True, True))
            rows.append(dict(
                name=f"conv3x3_fused_stats {stack}->{stack} @64^2",
                path=path, launches=launches["conv3x3_fused_stats"],
                serve_launches=run["capture"]["conv3x3_fused_stats"],
                **config_conv_row(C, g, table[label])))
            if mode in PUBLISHED_ARGV:
                config_test_twin(P, cfg, L, g, mode, base)
            torch.cuda.empty_cache()
    finally:
        L.set_compute_dtype(None)
        shutil.rmtree(base, ignore_errors=True)
    return rows


# ----------------------------------------------------------------- phase 10

# the training flags of each configuration beyond its inference ones
# (tests/test_train_variants.py, from the reference README's training
# command lines; celebahqedge's are an assumption, PERF.md section 4), and
# their command-line form
CONFIG_TRAIN = {
    "celebahq": dict(weight_mask=100.0, warp_cycle_w=0.1,
                     which_perceptual="4_2", weight_perceptual=0.001,
                     fm_ratio=1.0),
    "celebahqedge": dict(warp_bilinear=True, warp_cycle_w=0.1,
                         which_perceptual="4_2", weight_perceptual=0.001,
                         fm_ratio=1.0),
    "deepfashion": dict(warp_self_w=100.0, real_reference_probability=0.0,
                        which_perceptual="4_2"),
}
CONFIG_TRAIN_ARGV = {
    "celebahq": ["--weight_mask", "100.0", "--warp_cycle_w", "0.1",
                 "--which_perceptual", "4_2", "--weight_perceptual", "0.001",
                 "--fm_ratio", "1.0", "--vgg_normal_correct"],
    "celebahqedge": ["--warp_bilinear", "--warp_cycle_w", "0.1",
                     "--which_perceptual", "4_2", "--weight_perceptual",
                     "0.001", "--fm_ratio", "1.0", "--vgg_normal_correct"],
}
# the ade20k cycle family on the flagship's training flags:
# tests/test_train_variants.py's test_cycle_mask_and_two_cycle
CYCLE_FAMILY = dict(warp_mask_losstype="cycle", weight_mask=10.0,
                    warp_cycle_w=1.0, two_cycle=True)
# the loss terms of each configuration's step (tests/test_torch_train_
# configs.py holds them to the JAX package's)
_COMMON_LOSSES = {"no_vgg_feat", "GAN", "GAN_Feat", "fm", "perc",
                  "contextual", "D_Fake", "D_real"}
CONFIG_LOSS_KEYS = {"celebahq": _COMMON_LOSSES | {"G_warp_cycle", "mask"},
                    "celebahqedge": _COMMON_LOSSES | {"G_warp_cycle"},
                    "deepfashion": _COMMON_LOSSES | {"G_warp_self"}}
CONFIG_TRAIN_STEPS = 3


def config_train_opt(cfg, mode, **kw):
    """A published configuration's training flags, with the flagship's
    --vgg_normal_correct, at full width (256 px, ngf 64, ndf 64) and batch
    8, or with the keywords given."""
    return config_opt(cfg, mode, **{**CONFIG_TRAIN[mode], "isTrain": True,
                                    "vgg_normal_correct": True,
                                    "batchSize": 8, "ndf": 64, **kw})


def config_train_twin(L, mode, base) -> None:
    """The train twin (cli/train.py) at full width, batch 4, on a synthetic
    CelebA-HQ tree (8 training photos of 288 x 288: 2 G steps): the shift9
    pair launched as TRAIN_LAUNCHES states a step, the configuration's
    loss terms finite, state_latest/ written and the grid of the second
    step; then the test twin (cli/test.py) on that checkpoint: its nets
    bit for bit the trained ones, a finite output. Prints s/step with the
    host pipeline."""
    import statistics
    from cocosnet_tpu_torch.cli import test as TTEST
    from cocosnet_tpu_torch.cli import train as TTRAIN
    from cocosnet_tpu_torch.data import synthetic as SYN
    from cocosnet_tpu_torch.train import checkpoints as CK
    root, tables = os.path.join(base, "celeb"), os.path.join(base, "tables")
    if not os.path.isdir(root):
        SYN.make_celebahq_tree(root, n_train=8, n_val=4, size=288,
                               block=32, table_dir=tables)
    ck, out = os.path.join(base, "checkpoints"), os.path.join(base, "output")
    flags = ["--dataset_mode", mode, "--dataroot", root, "--ref_table_dir",
             tables, "--batchSize", "4", "--crop_size", "256",
             "--load_size", "256", "--nThreads", "4", "--checkpoints_dir",
             ck, "--name", mode, "--output_dir", out] + PUBLISHED_ARGV[mode]
    counted = counted_entries()
    _zero_counts(counted)
    try:
        run = TTRAIN.main(flags + ["--niter", "1", "--niter_decay", "0",
                                   "--save_epoch_freq", "1",
                                   "--print_freq", "4", "--display_freq",
                                   "8"] + CONFIG_TRAIN_ARGV[mode])
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counted.items()}
        want = {k: n * run.g_steps for k, n in TRAIN_LAUNCHES[mode].items()}
        _check(run.g_steps == 2 and run.d_steps == 0 and launches == want,
               f"{mode} train twin: 2 G steps, launches {launches} == {want}")
        _check(set(run.losses) == CONFIG_LOSS_KEYS[mode] and all(
            v == v and abs(v) < float("inf") for v in run.losses.values()),
            f"{mode} train twin: last losses finite: " + ", ".join(
                f"{k} {v:.4g}" for k, v in sorted(run.losses.items())))
        files = set(os.listdir(os.path.join(ck, mode, "state_latest")))
        # no EMA shadows: the configuration's flags leave --use_ema off
        _check(files == {*CK.NET_FILES.values(), CK.OPTIMIZER_FILE},
               f"{mode} train twin: state_latest/ holds {sorted(files)}")
        size = PILImage.open(os.path.join(out, "training", mode,
                                          "1_8.png")).size
        _check(size == (4 * 256, 5 * 256), f"{mode} train twin grid 1_8.png "
               f"{size} (label, ref, warp, fake and real rows of 4)")
        print(f"{mode} train twin batch 4: "
              f"{statistics.median(run.step_seconds[1:]):.4f} s/step (host "
              f"clock over the loop, the loader included)", flush=True)
        test = TTEST.main(flags + ["--which_epoch", "latest"])
        torch.cuda.synchronize()
        for net in ("gen", "corr"):
            got = getattr(test.nets, net).state_dict()
            live = getattr(run.nets, net).state_dict()
            _check(got.keys() == live.keys() and all(
                torch.equal(got[k], live[k]) for k in got),
                f"{mode} test twin on the train twin's state_latest/: its "
                f"{net}, {len(got)} tensors, bit for bit the trained one")
        _check(test.images == 4 and bool(
            torch.isfinite(torch.from_numpy(test.first_fake)).all()),
            f"{mode} test twin: 4 images, the fake finite")
        del run, test
    finally:
        L.set_compute_dtype(None)
        import shutil
        shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()


def config_trainings(P, cfg, L, TS, ST, g) -> dict:
    """Phase 10: the training of celebahq, celebahqedge and deepfashion on
    the card. (a) For each, and for the ade20k cycle family, the small f32
    train path on the card against the plain versions on the CPU (phase
    3b's checks and tolerances), at 128 x 256, ngf 16, ndf 16, batch 1,
    with each mode's own label channels. (b) Each at full width (256 px,
    ngf 64, ndf 64), batch 8, bf16 policy, through make_train_step
    (train_path). (c) The train twin on a synthetic CelebA-HQ tree for the
    two CelebA-HQ modes, then the test twin on its checkpoint
    (deepfashion's pose rendering needs OpenCV). Returns the launches of
    each full-width step by path."""
    import shutil
    import tempfile
    with train_route("kernels"):
        for mode in PUBLISHED:
            opt = config_train_opt(cfg, mode, aspect_ratio=2.0, batchSize=1,
                                   ngf=16, ndf=16)
            ref = cpu_train_reference(
                P, L, TS, ST, g, opt,
                config_batch(g, mode, 1, 128, 256, opt.semantic_nc))
            train_reference_check(P, L, TS, ST, ref, f"{mode} training",
                                  _attend_part(TRAIN_LAUNCHES[mode]),
                                  "kernels")
            del ref
        opt = small_train_opt(cfg, **CYCLE_FAMILY)
        ref = cpu_train_reference(P, L, TS, ST, g, opt, make_batch(
            g, 1, 128, 256, opt.semantic_nc))
        train_reference_check(P, L, TS, ST, ref,
                              "ade20k cycle mask, two_cycle training",
                              _attend_part(TRAIN_LAUNCHES["ade20k cycle"]),
                              "kernels")
        del ref
        torch.cuda.empty_cache()
        runs = {}
        L.set_compute_dtype(torch.bfloat16)
        try:
            for mode in PUBLISHED:
                opt = config_train_opt(cfg, mode)
                runs[f"{mode} train step"] = train_path(
                    P, TS, ST, g, opt,
                    lambda: config_batch(g, mode, 8, 256, 256,
                                         opt.semantic_nc),
                    f"{mode} training", TRAIN_LAUNCHES[mode],
                    CONFIG_LOSS_KEYS[mode], CONFIG_TRAIN_STEPS)
        finally:
            L.set_compute_dtype(None)
    base = tempfile.mkdtemp(prefix="cocosnet_config_train_")
    try:
        for mode in PUBLISHED_ARGV:
            config_train_twin(L, mode, base)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return runs


# ----------------------------------------------------------------- phase 11

# the spatial-parallel (SP) correlation's shard at 512 px: B1, a 128 x 128
# feature map (N = 16384 keys), C 256, D 154 (3 colours + 151 classes); a
# model rank of m owns N / m query rows
SP_HW, SP_C, SP_D = 128, 256, 154


def check_shift9_rect(S, g, *, m, swap, square):
    """The rectangular shift9 kernels at model rank 1's shard of m (query
    rows N/m .. 2N/m against all N keys; with `swap` the draws of query
    and key traded, as the column warp calls them): the forward against its
    plain version (phase 2's bounds), the backward against an f64 run of
    shift9_bwd_plain at 1e-4 of each output's scale; then both timed beside
    their plain versions, SDPA f32 on the unfolded descriptors at the same
    (nq, nk) (forward; forward + backward) and their bounds. `square`: the
    square kernels' ms at B1 128 x 128, printed beside. Returns the rows
    (forward, backward)."""
    from cocosnet_tpu_torch.tools.bench_corr import descriptor
    dev = "cuda"
    b, h, w, c, d = 1, SP_HW, SP_HW, SP_C, SP_D
    n = h * w
    nq = n // m
    f = torch.randn(b, h, w, c, generator=g).to(dev)
    gg = (torch.randn(b, h, w, c, generator=g) * 1.5 + 0.2).to(dev)
    if swap:
        f, gg = gg, f
    v = (torch.rand(b, n, d, generator=g) * 2 - 1).to(dev)
    go = torch.randn(b, nq, d, generator=g).to(dev)
    f3, g3, qv, kv = S.shift9_inputs(f, gg, 0.01, True)
    rows = slice(nq, 2 * nq)
    f3, qv = f3[:, rows].contiguous(), qv[:, rows].contiguous()
    label = (f"shift9 SP shard m {m}: nq {nq} x nk {n}, B1 C{c} D{d}"
             + (", roles swapped" if swap else ""))
    o, lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    po, plse = S.shift9_core_plain(f3, g3, v, qv, kv, w)
    torch.cuda.synchronize()
    err, lerr = _maxerr(o, po), _maxerr(lse, plse)
    _check(err <= 1e-4 and lerr <= 1e-3,
           f"{label} forward: o err {err:.3g} <= 1e-4, lse err {lerr:.3g} "
           f"<= 1e-3")
    del po, plse
    dd = (go * o).sum(-1)
    args = (f3, g3, v, qv, kv, lse, go, dd, w)
    got = S.shift9_bwd_kernel(*args)
    exact = S.shift9_bwd_plain(*(a.double() if torch.is_tensor(a) else a
                                 for a in args))
    torch.cuda.synchronize()
    scales = [float(r.abs().max()) for r in exact]
    errs = [_maxerr(a, r) for a, r in zip(got, exact)]
    del exact
    torch.cuda.empty_cache()
    _check(all(e <= BWD_REL_TOL * sc for e, sc in zip(errs, scales)),
           f"{label} backward kernel vs the f64 plain version: max err / "
           "max |out| " + ", ".join(f"{nm} {e / sc:.3g}" for nm, e, sc in
                                    zip(BWD_NAMES, errs, scales))
           + f" <= {BWD_REL_TOL:g}")
    again = S.shift9_bwd_kernel(*args)
    _check(all(torch.equal(a, r) for a, r in zip(got, again)),
           f"{label} backward: two launches give the same bits")
    del again
    fwd_ms = time_ms(lambda: S.shift9_core_kernel(f3, g3, v, qv, kv, w))
    bwd_ms = time_ms(lambda: S.shift9_bwd_kernel(*args), runs=5)
    fwd_plain = time_ms(lambda: S.shift9_core_plain(f3, g3, v, qv, kv, w),
                        runs=3)
    bwd_plain = time_ms(lambda: S.shift9_bwd_plain(*args), runs=3)
    torch.cuda.empty_cache()
    q, k = descriptor(f)[:, rows].contiguous(), descriptor(gg)
    lerr = _maxerr(sdpa(q, k, v, CORR_TAU), o)
    _check(lerr <= 1e-4, f"{label} yardstick: SDPA on the unfolded "
           f"descriptors vs the kernel: max err {lerr:.3g} <= 1e-4")
    lib_fwd = time_ms(lambda: sdpa(q, k, v, CORR_TAU), runs=5)
    backend = sdpa_backend(lambda: sdpa(q, k, v, CORR_TAU))
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa(qr, kr, vr, CORR_TAU), (qr, kr, vr), go), runs=5)
    del q, k, qr, kr, vr
    torch.cuda.empty_cache()
    fwd_flops = shift9_fwd_flops(b, nq, n, c, d)
    bwd_flops = shift9_bwd_flops(b, nq, n, c, d)
    fb = tc_bound(_nbytes(f3, g3, v, qv, kv) + b * nq * (d + 1) * 4,
                  fwd_flops)
    bb = tc_bound(_nbytes(*args[:-1]) + _nbytes(*got), bwd_flops)
    lib = f"F.scaled_dot_product_attention f32 on the unfolded C = 2304 " \
          f"descriptors, {backend}"
    print(f"     {label}: forward {fwd_ms:.3f} ms (square B1 128x128 "
          f"{square[0]:.3f}), plain {fwd_plain:.3f}, SDPA {lib_fwd:.3f}, "
          f"bound {fb[0]:.3f} ({fb[1]}: {fwd_flops / 1e9:.1f} GFLOP x "
          f"{SPLIT_PASSES} bf16 passes; 3xTF32 {fb[2]:.3f}); backward "
          f"{bwd_ms:.3f} ms (square {square[1]:.3f}), plain {bwd_plain:.3f},"
          f" SDPA forward + backward {lib_bwd:.3f}, bound {bb[0]:.3f} "
          f"({bwd_flops / 1e9:.1f} GFLOP x {SPLIT_PASSES}; 3xTF32 "
          f"{bb[2]:.3f})", flush=True)
    fwd = dict(max_abs_err=err, ms=fwd_ms, plain_ms=fwd_plain,
               bound_ms=fb[0], bound_by=fb[1], library_ms=lib_fwd,
               library=lib + ", forward", tf32x3_bound_ms=fb[2],
               fma_bound_ms=fb[3])
    bwd = dict(max_abs_err=max(errs), ms=bwd_ms, plain_ms=bwd_plain,
               bound_ms=bb[0], bound_by=bb[1], library_ms=lib_bwd,
               library=lib + ", forward + backward", tf32x3_bound_ms=bb[2],
               fma_bound_ms=bb[3])
    return fwd, bwd


def square_b1_ms(S, g):
    """(forward, backward) ms of the square shift9 kernels at B1 128 x 128,
    C 256, D 154: the single-card form of the SP shards."""
    dev = "cuda"
    b, h, w, c, d = 1, SP_HW, SP_HW, SP_C, SP_D
    f = torch.randn(b, h, w, c, generator=g).to(dev)
    gg = (torch.randn(b, h, w, c, generator=g) * 1.5 + 0.2).to(dev)
    v = (torch.rand(b, h * w, d, generator=g) * 2 - 1).to(dev)
    f3, g3, qv, kv = S.shift9_inputs(f, gg, 0.01, True)
    o, lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    go = torch.randn(b, h * w, d, generator=g).to(dev)
    args = (f3, g3, v, qv, kv, lse, go, (go * o).sum(-1), w)
    out = (time_ms(lambda: S.shift9_core_kernel(f3, g3, v, qv, kv, w)),
           time_ms(lambda: S.shift9_bwd_kernel(*args), runs=5))
    torch.cuda.empty_cache()
    return out


def sp_inference_opt(cfg, model):
    """The flagship inference configuration at 512 px, batch 1, f32: the
    README's --mesh_model N inference (README.md:103-115)."""
    return inference_opt(cfg, 3).replace(crop_size=512, load_size=512,
                                         batchSize=1, compute_dtype="f32",
                                         mesh_model=model)


def sp_train_opt(cfg, data, model):
    """The flagship training configuration (ngf 64, ndf 64, 151 classes,
    EMA, weight_mask 100) at 128 px, global batch 2, f32."""
    return train_opt(cfg, crop_size=128, load_size=128, batchSize=2,
                     compute_dtype="f32", mesh_data=data, mesh_model=model)


def sp_nets(P, opt, seed):
    """The nets of `opt` on the card, every net's weights at unit signal
    scale from `seed` alone: each process of a job draws the same."""
    nets = P.Pix2PixNets(opt, device="cuda", seed=seed)
    for i, net in enumerate(nets.modules()):
        condition_weights(net, torch.Generator().manual_seed(seed + i),
                          "cuda")
    return nets


def sp_batch(opt, seed):
    """The run's global batch from `seed`; self_ref [1, 0] at batch 2, so
    the batch-coupled loss terms need the global batch's sums."""
    batch = make_batch(torch.Generator().manual_seed(seed), opt.batchSize,
                       opt.crop_size, opt.crop_size, opt.semantic_nc)
    batch["self_ref"][1:] = 0.0
    return batch


def sp_runs(P, cfg, TS, ST, data, model):
    """On this process's rank of the registered mesh (data x model): the
    512 px inference (model > 1, or the reference at data = model = 1) and
    one 128 px train step, each on this rank's data shard, with the kernels'
    launches of each (counts set to 0 just before). Returns the fakes, the
    losses, the parameters after the step (on the host) and the launches."""
    from cocosnet_tpu_torch import mesh as M
    mesh = M.global_mesh()
    counted = counted_entries()
    out = {}
    if data == 1:
        opt = sp_inference_opt(cfg, model)
        nets = sp_nets(P, opt, 50)
        batch = sp_batch(opt, 60)
        _zero_counts(counted)
        fake = ST.make_inference_step(nets)(batch)["fake_image"]
        torch.cuda.synchronize()
        out["infer_launches"] = {k: fn.launches for k, fn in counted.items()}
        out["infer_fake"] = fake.cpu()
        del nets, fake
        torch.cuda.empty_cache()
    opt = sp_train_opt(cfg, data, model)
    nets = sp_nets(P, opt, 70)
    batch = sp_batch(opt, 80)
    b = opt.batchSize // mesh.data
    shard = {k: v[mesh.data_rank * b:(mesh.data_rank + 1) * b]
             for k, v in batch.items()}
    p0 = {net: {k: t.detach().cpu().clone() for k, t in
                getattr(nets, net).named_parameters()} for net in TRAINED}
    state = TS.create_train_state(opt, nets)
    if mesh.size > 1:
        # phase 15: a gloo job on the card refuses the captured chunk
        try:
            ST.make_multi_train_step(nets)
            out["refused"] = ""
        except RuntimeError as err:
            out["refused"] = str(err)
    _zero_counts(counted)
    losses, visuals = ST.make_train_step(nets)(state, shard,
                                               TS.lrs_for_epoch(opt, 1))
    torch.cuda.synchronize()
    out["train_launches"] = {k: fn.launches for k, fn in counted.items()}
    out["losses"] = {k: float(v) for k, v in losses.items()}
    out["train_fake"] = visuals["fake_image"].cpu()
    if mesh.size == 1:   # every rank's start, drawn from the same seed
        out["p0"] = p0
    out["p1"] = {net: {k: t.detach().cpu().clone() for k, t in
                       getattr(nets, net).named_parameters()}
                 for net in TRAINED}
    del nets, state
    if model == 1:
        # phase 12 (d): configuration (a), the synchronized BatchNorm's
        # moments over the data ranks (the one process and the data job)
        opt = sp_train_opt(cfg, data, model).replace(**DEFAULT_NORM)
        nets = sp_nets(P, opt, 90)
        batch = sp_batch(opt, 100)
        shard = {k: v[mesh.data_rank * b:(mesh.data_rank + 1) * b]
                 for k, v in batch.items()}
        state = TS.create_train_state(opt, nets)
        if mesh.size == 1:
            out["bn_p0"] = {net: {k: t.detach().cpu().clone() for k, t in
                                  getattr(nets, net).named_parameters()}
                            for net in TRAINED}
        losses, _ = ST.make_train_step(nets)(state, shard,
                                             TS.lrs_for_epoch(opt, 1))
        out["bn_losses"] = {k: float(v) for k, v in losses.items()}
        out["bn_p1"] = {net: {k: t.detach().cpu().clone() for k, t in
                              getattr(nets, net).named_parameters()}
                        for net in TRAINED}
        out["bn_stats"] = {k: t.cpu().clone() for net in TRAINED
                           for k, t in getattr(nets, net).state_dict().items()
                           if k.endswith(("running_mean", "running_var"))}
        del nets, state
    torch.cuda.empty_cache()
    return out


def sp_worker(rank, world, init, data, model, tmp):
    """One rank of phase 11's jobs: gloo on the one card (the processes
    share it), the mesh registered, sp_runs saved for the parent."""
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cocosnet_tpu_torch import config as cfg
    from cocosnet_tpu_torch import mesh as M
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.nn import layers as L
    from cocosnet_tpu_torch.train import state as TS
    from cocosnet_tpu_torch.train import steps as ST
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    L.set_compute_dtype(None)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    M.set_global_mesh(M.create_mesh(data, model))
    try:
        res = sp_runs(P, cfg, TS, ST, data, model)
    finally:
        M.shutdown()
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def sp_job(data, model, tmp):
    """Starts every rank of a data x model job of processes sharing the
    card over gloo (a file:// rendezvous in a directory of its own under
    tmp); returns a function that waits for them and returns their
    results."""
    import torch.multiprocessing as mp
    world = data * model
    where = os.path.join(tmp, f"{data}x{model}")
    os.makedirs(where)
    init = "file://" + os.path.join(where, "store")
    ctx = mp.start_processes(sp_worker, args=(world, init, data, model, where),
                             nprocs=world, join=False, start_method="spawn")

    def results() -> list:
        while not ctx.join():
            pass
        return [torch.load(os.path.join(where, f"rank{r}.pt"))
                for r in range(world)]
    return results


def _allclose(a, b, rtol, atol) -> float:
    """The largest |a - b| / (atol + rtol |b|): within the bound at <= 1."""
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def parallelism(P, cfg, TS, ST) -> dict:
    """Phase 11, parts 2-4: the 512 px SP inference and the 128 px train
    step with the query rows over two model ranks, the train step over two
    data ranks (two processes sharing the card over gloo each time), held
    against one process on the same weights and batch; then a one-rank
    NCCL group. Returns the model job's launches (per rank) of each."""
    import tempfile

    import torch.distributed as dist

    from cocosnet_tpu_torch import mesh as M
    # the two jobs and the one process run at once (the script's time;
    # they ran one after another before phases 13 and 14 came)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    t0 = time.perf_counter()
    jobs = [sp_job(1, 2, tmp), sp_job(2, 1, tmp)]
    M.set_global_mesh(None)
    one = sp_runs(P, cfg, TS, ST, 1, 1)
    torch.cuda.empty_cache()
    model_job, data_job = (results() for results in jobs)
    print(f"     the 1 x 2 and 2 x 1 jobs and the one process took "
          f"{time.perf_counter() - t0:.1f} s together (four processes "
          f"spawned, and this one, on the one card)", flush=True)
    for r, res in enumerate(model_job):
        worst = _allclose(res["infer_fake"], one["infer_fake"], 1e-4, 2e-4)
        _check(worst <= 1 and res["infer_launches"]["attend_shift9"] == 1,
               f"SP inference 512 px B1 f32, model rank {r} of 2: fake vs "
               f"one process at atol 2e-4 / rtol 1e-4 (worst "
               f"{worst:.3g} of the bound); one rectangular shift9 forward "
               f"a rank ({res['infer_launches']['attend_shift9']})")
        lw = max(_allclose(torch.tensor(res["losses"][k]),
                           torch.tensor(v), 2e-2, 5e-3)
                 for k, v in one["losses"].items())
        pw = max(_allclose(res["p1"]["corr"][k], v, 2e-2, 5e-4)
                 for k, v in one["p1"]["corr"].items())
        tl = res["train_launches"]
        _check(lw <= 1 and pw <= 1 and tl["attend_shift9"] == 1
               and tl["attend_shift9_backward"] == 1,
               f"SP train step 128 px B2 f32, model rank {r} of 2 vs one "
               f"process: losses at rtol 2e-2 / atol 5e-3 (worst {lw:.3g} of "
               f"the bound), corr's parameters after the step at rtol 2e-2 "
               f"/ atol 5e-4 (worst {pw:.3g}); shift9 forward and backward "
               f"launches a rank {tl['attend_shift9']}, "
               f"{tl['attend_shift9_backward']}")
        ups = {net: _rel_l2(res["p1"][net], one["p1"][net], one["p0"][net])
               for net in TRAINED}
        _check(max(ups.values()) <= 0.1,
               f"SP train step, model rank {r}: each net's update p1 - p0 "
               f"vs one process's, relative L2 <= 0.1: " + ", ".join(
                   f"{k} {v:.3g}" for k, v in ups.items()))
    for r, res in enumerate(data_job):
        lw = max(abs(res["losses"][k] - v) / (abs(v) + 1e-2)
                 for k, v in one["losses"].items())
        fw = _maxerr(res["train_fake"], one["train_fake"][r:r + 1])
        ups = {net: _rel_l2(res["p1"][net], one["p1"][net], one["p0"][net])
               for net in TRAINED}
        _check(lw <= 2e-3 and fw <= 2e-4 and max(ups.values()) <= 0.1,
               f"data-parallel train step 128 px, data rank {r} of 2 (global "
               f"B2) vs one process at B2: losses rel {lw:.3g} <= 2e-3, its "
               f"shard's fake {fw:.3g} <= 2e-4, each net's update relative "
               f"L2 <= 0.1 (" + ", ".join(f"{k} {v:.3g}"
                                          for k, v in ups.items()) + ")")
    # phase 12 (d): configuration (a) at mesh_data 2 against one process:
    # the BatchNorm moments are the global batch's
    for r, res in enumerate(data_job):
        lw = max(abs(res["bn_losses"][k] - v) / (abs(v) + 1e-2)
                 for k, v in one["bn_losses"].items())
        sw = max(_maxerr(res["bn_stats"][k], v) / max(float(v.abs().max()),
                                                      1e-3)
                 for k, v in one["bn_stats"].items())
        ups = {net: _rel_l2(res["bn_p1"][net], one["bn_p1"][net],
                            one["bn_p0"][net]) for net in TRAINED}
        _check(len(one["bn_stats"]) > 0 and lw <= 2e-3 and sw <= 2e-3
               and max(ups.values()) <= 0.1,
               f"(d) default-norm train step 128 px, data rank {r} of 2 "
               f"(global B2) vs one process: losses rel {lw:.3g} <= 2e-3, "
               f"the {len(one['bn_stats'])} running statistics rel "
               f"{sw:.3g} <= 2e-3, each net's update relative L2 <= 0.1 ("
               + ", ".join(f"{k} {v:.3g}" for k, v in ups.items()) + ")")
    _check(all(torch.equal(data_job[0]["bn_stats"][k],
                           data_job[1]["bn_stats"][k])
               for k in data_job[0]["bn_stats"]),
           "(d) the data job's two ranks hold the same running statistics, "
           "bit for bit")
    for job, what in ((model_job, "model"), (data_job, "data")):
        same = all(torch.equal(job[0]["p1"][n][k], job[1]["p1"][n][k])
                   for n in TRAINED for k in job[0]["p1"][n])
        _check(same, f"the {what} job's two ranks end the step with the same "
               f"parameters, bit for bit")
        _check(all("cannot be captured" in r["refused"] for r in job),
               f"the {what} job (gloo on the card) refuses "
               f"make_multi_train_step: {job[0]['refused']!r}")
    # the backend choice where each rank has a card of its own: NCCL, one
    # rank (this machine has one card)
    backend = M.backend_for(torch.device("cuda"))
    M.init_process_group(backend, "file://" + os.path.join(tmp, "nccl"), 0,
                         1, 60)
    try:
        t = torch.arange(4.0, device="cuda")
        dist.all_reduce(t)
        gathered = [torch.empty_like(t)]
        dist.all_gather(gathered, t)
        torch.cuda.synchronize()
        _check(backend == "nccl" and dist.get_backend() == "nccl"
               and t.tolist() == [0.0, 1.0, 2.0, 3.0]
               and torch.equal(gathered[0], t),
               f"a one-rank {dist.get_backend()} group on the card: "
               f"all_reduce and all_gather of a CUDA tensor")
    finally:
        dist.destroy_process_group()
    print("     NCCL across cards is not run: this machine has "
          f"{torch.cuda.device_count()} card; the data and model jobs above "
          "share it over gloo", flush=True)
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return {"infer": model_job[0]["infer_launches"],
            "train": model_job[0]["train_launches"]}


# ------------------------------------------------------------ phase 12

# configuration (a): the reference's default norm_G
# (spectralspadesyncbatch3x3: synchronized BatchNorm in every SPADE block),
# neither --PONO nor --PONO_C; (b): the flagship plus every architecture
# extra of the adaptors, the correspondence net and D, and the two noise
# branches
DEFAULT_NORM = dict(PONO=False, PONO_C=False)
EXTRAS = dict(use_coordconv=True, adaptor_se=True, adaptor_nonlocal=True,
              adaptor_res_deeper=True, dilation_conv=True, D_cam=1.0,
              mask_noise=True, noise_for_mask=True)
# per step of (b): the row warp's shift9 pair; --remat_full re-runs the
# correspondence forward in the backward, so its shift9 forward twice
REMAT_LAUNCHES = {False: _launches(**SHIFT9),
                  True: _launches(attend_shift9=2, attend_shift9_backward=1)}


def calibrate_batchnorm(P, L, nets, batch) -> None:
    """Every BatchNorm's running statistics set to one train-mode forward's
    batch moments (momentum 1 for that forward), as a trained net holds
    them: at their initial 0 and 1 the eval forward of weights at unit
    signal scale saturates the generator's tanh."""
    from cocosnet_tpu_torch.nn.norms import BatchNorm
    norms = [m for net in (nets.gen, nets.corr) for m in net.modules()
             if isinstance(m, BatchNorm)]
    for m in norms:
        m.momentum = 1.0
    nets.set_train(True)
    try:
        with torch.no_grad(), L.training():
            P.generate_fake(nets, P.preprocess_input(nets.opt, batch),
                            train=True)
    finally:
        nets.set_train(False)
        for m in norms:
            m.momentum = 0.1


def graph_check(P, L, g, opt, tag) -> dict:
    """tools/serve.make_serve_step of `opt` (bf16 policy, weights at unit
    signal scale) at its batch: the capture call launches one eager
    forward's kernels, and two replays after one capture give the eager
    forward's bits. Returns the eager forward's launches and the graph's
    and the eager forward's ms."""
    from cocosnet_tpu_torch.tools import serve as SV
    from cocosnet_tpu_torch.train.steps import make_inference_step
    L.set_compute_dtype(torch.bfloat16)
    nets = P.Pix2PixNets(opt, seed=0)
    condition_weights(nets.corr, g, "cuda")
    condition_weights(nets.gen, g, "cuda")
    infer = make_inference_step(nets)
    b = opt.batchSize
    batches = [{k: v.cuda() for k, v in make_batch(
        g, b, 256, 256, opt.semantic_nc).items()} for _ in range(2)]
    calibrate_batchnorm(P, L, nets, batches[0])
    counted = counted_entries()
    _zero_counts(counted)
    want = [SV.quantize(infer(batches[0])["fake_image"])]
    torch.cuda.synchronize()
    forward = {k: fn.launches for k, fn in counted.items()}
    want.append(SV.quantize(infer(batches[1])["fake_image"]))
    step = SV.make_serve_step(nets, b)
    step.warm_up()
    _zero_counts(counted)
    step.capture()
    torch.cuda.synchronize()
    capture = {k: fn.launches for k, fn in counted.items()}
    _check(capture == forward, f"{tag}: the capture call launched "
           f"{capture}, one eager forward's launches")
    for i, batch in enumerate(batches):
        got = step(batch).clone()
        std = float(got.float().std())
        _check(torch.equal(got, want[i]) and std > 10,
               f"{tag}: replay {i + 1} after one capture has the eager "
               f"forward's bits (std {std:.1f} levels)")
    graph_ms = time_ms(lambda: step(batches[0]), runs=10)
    eager_ms = time_ms(lambda: SV.quantize(infer(batches[0])["fake_image"]),
                       runs=10)
    print(f"{tag}: graph {graph_ms:.2f} ms, eager {eager_ms:.2f} ms per "
          f"forward (CUDA events, 10 runs; {b * 1e3 / graph_ms:.2f} vs "
          f"{b * 1e3 / eager_ms:.2f} images/s)", flush=True)
    del step, nets, infer, batches, want
    torch.cuda.empty_cache()
    L.set_compute_dtype(None)
    return dict(launches=forward, graph_ms=graph_ms, eager_ms=eager_ms)


def extras_forward(P, cfg, L, C, g) -> dict:
    """(b)'s B6 eager forward at flagship width (bf16 policy): its launches
    against the routing's prediction from its recorded convs (the one-hot
    conv and the shift9 forward beside them), the outputs' shapes and
    ranges, ms and images/s, then the conv3x3.cu table of the forward
    (forward_conv_table), the coordconv stack's 410->410 statistics conv
    among its rows. Returns the launches and that row."""
    from cocosnet_tpu_torch.tools import ab_dw as AB
    L.set_compute_dtype(torch.bfloat16)
    opt = inference_opt(cfg, 3).replace(**EXTRAS)
    nets = P.Pix2PixNets(opt, seed=0)
    condition_weights(nets.corr, g, "cuda")
    condition_weights(nets.gen, g, "cuda")
    batch = make_batch(g, 6, 256, 256, opt.semantic_nc)
    data = P.preprocess_input(opt, batch)
    counted = counted_entries()
    _zero_counts(counted)
    res = []
    records = AB.record_convs(lambda: res.append(P.inference(nets, data)))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    predicted = _launches(attend_shift9=1, **AB.predicted_launches(records))
    tag = "(b) extras B6 forward"
    _check(launches == predicted and launches["conv3x3_onehot"] == 1,
           f"{tag}: launched {launches} == {predicted}, the routing's "
           f"prediction from its {len(records)} convs (the dilated ones on "
           f"cuDNN)")
    out = res[0]
    fake = out["fake_image"]
    _check(tuple(fake.shape) == (6, 256, 256, 3)
           and bool(torch.isfinite(fake).all())
           and float(fake.abs().max()) <= 1.0
           and bool(torch.isfinite(out["warp_mask"]).all()),
           f"{tag}: fake_image (6, 256, 256, 3) finite in [-1, 1], "
           f"warp_mask finite")
    fwd_ms = time_ms(lambda: P.inference(nets, data), runs=5)
    print(f"{tag}: {fwd_ms:.2f} ms per forward, {6e3 / fwd_ms:.2f} "
          f"images/s (CUDA events, 5 runs); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del nets, data, res, out, fake
    torch.cuda.empty_cache()
    L.set_compute_dtype(None)
    table = forward_conv_table(
        P, cfg, L, C, g, opt=opt, batch=batch, tag="(b) extras B6",
        expected=launches["conv3x3_fused"] + launches["conv3x3_fused_stats"])
    row = table["6,64,64,410->410,reflect,stats"]
    return dict(launches=launches, row=row, ms=fwd_ms)


def explicit_matrix_check(P, cfg, g) -> None:
    """(c): the explicit-matrix correspondence (return_corr, and
    WTA_scale_weight 1e-4) on the card against the CPU's plain run, at a
    small size (64 x 64, ngf 16, f32): the (B, 256, 256) matrix at 1e-4 of
    its scale (1/tau amplifies the descriptors' f32 error 100x), the warp
    and the mask it makes at atol 5e-4."""
    opt = cfg.test_defaults(
        dataset_mode="ade20k", label_nc=12, contain_dontcare_label=True,
        crop_size=64, load_size=64, batchSize=2, ngf=16, maskmix=True,
        PONO=True, PONO_C=True, warp_mask_losstype="direct", isTrain=False)
    batch = make_batch(g, 2, 64, 64, opt.semantic_nc)
    cpu = P.Pix2PixNets(opt, device="cpu", seed=1)
    condition_weights(cpu.corr, g, "cpu")
    gpu = P.Pix2PixNets(opt, device="cuda", seed=1)
    gpu.corr.load_state_dict(cpu.corr.state_dict())
    outs = []
    for nets, dev in ((cpu, "cpu"), (gpu, "cuda")):
        d = P.preprocess_input(opt, batch, device=dev)
        args = (d["ref_image"], d["input_semantics"], d["ref_semantics"])
        with torch.no_grad():
            outs.append((nets.corr(*args, return_corr=True)["corr"].cpu(),
                         {k: v.cpu() for k, v in nets.corr(
                             *args, WTA_scale_weight=1e-4).items()}))
    (want, want_w), (got, got_w) = outs
    scale = float(want.abs().max())
    err = _maxerr(got, want)
    werr = max(_maxerr(got_w[k], want_w[k]) for k in ("warp_out",
                                                      "warp_mask"))
    _check(tuple(got.shape) == (2, 256, 256) and err <= 1e-4 * scale
           and werr <= 5e-4,
           f"(c) explicit-matrix correspondence on the card vs the CPU: corr "
           f"max err {err:.3g} <= 1e-4 x {scale:.3g}; WTA 1e-4 warp and mask "
           f"max err {werr:.3g} <= 5e-4")


def remat_ring_check(runs) -> None:
    """(b)'s steps with and without --remat (their launches in `runs`):
    the reflect ring's backward launches alike, by ring width, the dilated
    blocks' p 2 among them, since a conv's ring takes one backward whether
    or not its block is recomputed (ring_launch_check)."""
    tags = [t for t in runs if t.startswith("(b) extras B8 training")]
    bwd = {t: {k: v for k, v in runs[t].items()
               if k.startswith("reflect_ring_backward")} for t in tags}
    _check(len(tags) == 3 and all(bwd[t] == bwd[tags[0]] for t in tags)
           and bwd[tags[0]].get("reflect_ring_backward p2", 0) > 0,
           f"(b) the reflect ring's backward launches alike with and "
           f"without --remat: {bwd}")


def architecture_branches(P, cfg, L, C, TS, ST, g) -> dict:
    """Phase 12: the branches off the flagship at flagship width (256 px,
    ngf / ndf 64, match_kernel 3, bf16 policy):
    (a) the reference's default norm (synchronized BatchNorm SPADE, no
        PONO): the small slice and two small f32 train steps against the
        CPU's plain run (phase 3 / 3b's checks, the running statistics
        too), the B6 eager forward and its serve graph, B8 training;
    (b) the extras (coordconv, SE, nonlocal, the deeper dilated adaptor,
        the CAM discriminator, mask noise and noise_for_mask): the B6
        forward with its conv3x3.cu table, B8 training without remat, with
        --remat (conv_small) and with --remat --remat_full;
    (c) the explicit-matrix correspondence at a small size.
    Returns {path: launches} and the records of its kernel rows."""
    out, info = {}, {}
    t12 = time.perf_counter()
    # (a)
    reference_check(P, cfg, g, 3, flags=DEFAULT_NORM,
                    tag=" (a) default norm")
    opt = small_train_opt(cfg, **DEFAULT_NORM)
    ref = cpu_train_reference(P, L, TS, ST, g, opt,
                              make_batch(g, 1, 128, 256, opt.semantic_nc))
    train_reference_check(P, L, TS, ST, ref, "(a) default norm",
                          _corr_launches(3, "kernels"), "kernels")
    del ref
    torch.cuda.empty_cache()
    graph = graph_check(P, L, g, inference_opt(cfg, 3).replace(
        **DEFAULT_NORM), "(a) default norm serve graph B6")
    _check(graph["launches"] == INFERENCE_LAUNCHES[3],
           f"(a) default norm B6 forward launched {graph['launches']} == "
           f"{INFERENCE_LAUNCHES[3]}")
    out["(a) inference"] = graph["launches"]
    L.set_compute_dtype(torch.bfloat16)

    def full(batch=8, **kw):
        return train_opt(cfg, label_nc=150, crop_size=256, load_size=256,
                         batchSize=batch, ngf=64, ndf=64, **kw)

    rec = {}
    out["(a) train step"] = train_path(
        P, TS, ST, g, full(**DEFAULT_NORM),
        lambda: make_batch(g, 8, 256, 256, 151),
        "(a) default norm training", TRAIN_LAUNCHES[(3, "kernels")],
        FLAGSHIP_LOSS_KEYS, 3, profile=True, out=rec)
    info["(a) B8"] = rec
    print(f"phase 12 (a) done in {time.perf_counter() - t12:.0f} s",
          flush=True)
    # (b)
    L.set_compute_dtype(None)
    fwd = extras_forward(P, cfg, L, C, g)
    out["(b) inference"] = fwd["launches"]
    info["(b) B6 ms"] = fwd["ms"]
    L.set_compute_dtype(torch.bfloat16)
    # (B16 with --remat before phase 15 came: the script's time)
    for b, remat, whole in ((8, False, False), (8, True, False),
                            (8, True, True)):
        tag = (f"(b) extras B{b} training"
               + (", --remat" if remat else "")
               + (" --remat_full" if whole else ""))
        rec = {}     # 2 timed steps (3 before phases 13 and 14 came)
        out[tag] = train_path(
            P, TS, ST, g, full(b, **EXTRAS, remat=remat,
                               remat_full=whole),
            lambda: make_batch(g, b, 256, 256, 151), tag,
            REMAT_LAUNCHES[whole], FLAGSHIP_LOSS_KEYS, 2, profile=False,
            out=rec)
        info[tag] = rec
    remat_ring_check(out)
    L.set_compute_dtype(None)
    # (c)
    explicit_matrix_check(P, cfg, g)
    print("phase 12 readings: " + json.dumps(info), flush=True)
    print(f"phase 12 took {time.perf_counter() - t12:.0f} s", flush=True)
    return out, fwd["row"]


# ----------------------------------------------------------------- phase 13

# tests/test_trajectory_parity.py's schedule, steps 0-3 (|t| + 1e-2 below)
TRAJ_TOLS = (2e-3, 2e-2, 5e-2, 2e-1)
# (50 before phase 15 came: the script's time)
TRAJ_STEPS = 10
# the kernel route's launches a step of the trajectory's setting (match
# kernel 1, 64 px: N = M = 256)
TRAJ_LAUNCHES = _launches(attend_corr=1, attend_corr_backward=1)


def trajectory() -> dict:
    """Phase 13: the training trajectory at tools/parity_trajectory.py's
    setting (match_kernel 1, 64 px, batch 2, ngf 64, ndf 16, EMA, TTUR;
    cocosnet_tpu_torch/tools/parity_trajectory.run_port), the same seeded
    batches and conditioned weights on every route. (a) Four f32 steps on
    the kernel route on the card against the same route's plain versions on
    the CPU, held to the schedule of tests/test_trajectory_parity.py, with
    corr_fwd.cu / corr_bwd.cu launched once a step. (b) TRAJ_STEPS steps of
    the f32 library route, the f32 kernel route and the bf16 kernel route on
    the card, every term finite on every step; each route's mean and max
    rel per term against the f32 library route printed beside
    PARITY_TRAJECTORY.json's JAX-against-reference figures (measurements:
    tau 0.01 makes the dynamics chaotic, and no bound holds them yet).
    Returns the kernel route's launches over the four steps of (a)."""
    from cocosnet_tpu_torch.tools import parity_trajectory as PT
    batches = PT.make_batches(TRAJ_STEPS)
    init_sd, vgg_sd = PT.make_init_sd(0), PT.make_vgg_sd(7)
    t = time.perf_counter()
    cpu, _ = PT.run_port(batches[:len(TRAJ_TOLS)], init_sd, vgg_sd, "cpu",
                         "kernels")
    cpu_s = time.perf_counter() - t
    counted = counted_entries()
    _zero_counts(counted)
    card, _ = PT.run_port(batches[:len(TRAJ_TOLS)], init_sd, vgg_sd, "cuda",
                          "kernels")
    launches = {k: fn.launches for k, fn in counted.items()}
    steps = len(TRAJ_TOLS)
    want = {k: n * steps for k, n in TRAJ_LAUNCHES.items()}
    _check(launches == want, f"trajectory kernel route: {steps} steps "
           f"launched {launches} == {want} (corr_fwd.cu and corr_bwd.cu "
           f"once a step)")
    _check(set(card) == set(cpu) == set(FLAGSHIP_LOSS_KEYS),
           f"trajectory terms {sorted(card)}")
    worst = {}
    for term in sorted(cpu):
        for s, tol in enumerate(TRAJ_TOLS):
            a, b = cpu[term][s], card[term][s]
            rel = abs(b - a) / (abs(a) + 1e-2)
            if rel / tol > worst.get(term, (0.0, 0, 0.0))[0]:
                worst[term] = (rel / tol, s, rel)
            _check(bool(np.isfinite(b)) and rel < tol,
                   f"trajectory f32 kernel route, card vs CPU, {term} step "
                   f"{s}: {b:.6g} vs {a:.6g}, rel {rel:.3g} < {tol:g}")
    print("trajectory (a): per term the step nearest its bound (rel / "
          "tol): " + ", ".join(f"{k} step {s} {r:.2g} ({f:.2f})"
                              for k, (f, s, r) in worst.items())
          + f"; the CPU's 4 steps took {cpu_s:.1f} s", flush=True)
    runs = {}
    for route, dtype in (("library", "f32"), ("kernels", "f32"),
                         ("kernels", "bf16")):
        t = time.perf_counter()
        curves, _ = PT.run_port(batches, init_sd, vgg_sd, "cuda", route,
                                dtype)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        _check(all(len(v) == TRAJ_STEPS and bool(np.isfinite(v).all())
                   for v in curves.values()),
               f"trajectory {dtype} {route} route: {TRAJ_STEPS} steps, every "
               f"term finite on every step ({dt:.1f} s, "
               f"{1e3 * dt / TRAJ_STEPS:.1f} ms a step with set-up)")
        runs[(route, dtype)] = curves
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "PARITY_TRAJECTORY.json")) as f:
        jax_ref = json.load(f)
    base = runs[("library", "f32")]
    print(f"trajectory (b): {TRAJ_STEPS} steps on the card, rel |x - f32 "
          "library| / (|f32 library| + 1e-3), mean / max per term, beside "
          "PARITY_TRAJECTORY.json's JAX against the reference (mean / max):",
          flush=True)
    for term in sorted(base):
        t0 = np.asarray(base[term])
        cells = []
        for key in (("kernels", "f32"), ("kernels", "bf16")):
            rel = np.abs(np.asarray(runs[key][term]) - t0) / (
                np.abs(t0) + 1e-3)
            cells.append(f"{key[1]} {key[0]} {rel.mean():.4g} / "
                         f"{rel.max():.4g}")
        ref = jax_ref.get(term, {})
        print(f"     {term:12s} " + "; ".join(cells)
              + f"; JAX vs reference {ref.get('mean_rel', float('nan')):.4g}"
                f" / {ref.get('max_rel', float('nan')):.4g}; f32 library "
                f"first {t0[0]:.4g} last {t0[-1]:.4g}", flush=True)
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- phase 14

def _sum_launches(*dicts) -> dict:
    out = {}
    for d in dicts:
        for k, n in d.items():
            out[k] = out.get(k, 0) + n
    return out


def _nonzero(launches: dict) -> dict:
    return {k: n for k, n in launches.items() if n}


def profile_twins(phase4: dict, phase5: dict) -> dict:
    """Phase 14, the profile twins: tools/profile_inference.py at mk3 B6
    and tools/profile_train.py at mk3 B8 (bf16 policy), their tables
    printed and written to build/profiles/; each stage's profile must record
    every launch its wrappers counted (the twins raise otherwise), and the
    hand-written launches of the stages must be those phases 4 and 5 hold:
    the full forward INFERENCE_LAUNCHES[3], the correspondence and the
    generator together the same, the gather one-hot adaptor the one-hot
    conv once, the residual stack its 8 statistics convs, attend_shift9 the
    shift9 forward once; the full step and the G phase TRAIN_LAUNCHES[(3,
    "kernels")], the G forward the shift9 forward once, the other segments
    none. Prints each full path's device-busy ms beside phases 4's and 5's
    (`phase4`, `phase5`: their records). Returns the full forward's and the
    full step's launches."""
    from cocosnet_tpu_torch.tools import profile_inference as PI
    from cocosnet_tpu_torch.tools import profile_train as PTR
    rows = PI.main(["--iters", "3"])
    inf = {r["name"].strip(): r["launches"] for r in rows}
    full = _nonzero(INFERENCE_LAUNCHES[3])
    _check(inf["full inference"] == full
           and _sum_launches(inf["correspondence total"],
                             inf["generator total"]) == full
           and inf["adaptor (seg, gather-onehot)"].get("conv3x3_onehot") == 1
           and "conv3x3_onehot" not in inf["adaptor (seg, 151ch)"]
           and inf["residual stack (4x407ch)"] == {"conv3x3_fused_stats": 8}
           and inf["attend_shift9 (fused kernel)"] == {"attend_shift9": 1}
           and not inf["correlation attend (C=2304)"],
           f"profile_inference: every stage's hand-written launches as the "
           f"forward's ({full}): {inf}")
    print(f"profile_inference full forward device busy "
          f"{_ms(rows[3]['profile']['busy_ms'])} ms; phase 4's "
          f"{_ms(phase4.get('busy_ms'))} ms", flush=True)
    rows = PTR.main(["--iters", "2"])
    seg = {r["name"].strip(): r["launches"] for r in rows}
    step = _nonzero(TRAIN_LAUNCHES[(3, "kernels")])
    _check(seg["full train_step"] == step
           and seg["G phase (bwd+adam+EMA)"] == step
           and seg["G fwd (losses)"] == {"attend_shift9": 1}
           and not any(seg[k] for k in seg if k not in (
               "full train_step", "G phase (bwd+adam+EMA)",
               "G fwd (losses)")),
           f"profile_train: every segment's hand-written launches as the "
           f"step's ({step}): {seg}")
    print(f"profile_train full step device busy "
          f"{_ms(rows[-1]['profile']['busy_ms'])} ms; phase 5's "
          f"{_ms(phase5.get('busy_ms'))} ms", flush=True)
    return {"inference": inf["full inference"],
            "train step": seg["full train_step"]}


def tool_twins() -> None:
    """Phase 14, the other tools: eval_metrics' VGG19 features of 16
    synthetic images on the card against the CPU (f32, TF32 off: relative
    L2 within 1e-4), SWD and FID on them; mask_to_edge on phase 9's
    synthetic CelebA-HQ tree, its stack equal to the one
    data/celebahqedge.get_label_tensor builds for the same id with no flip
    and no crop."""
    import shutil
    import tempfile

    from cocosnet_tpu_torch.config import test_defaults
    from cocosnet_tpu_torch.data import synthetic as SYN
    from cocosnet_tpu_torch.data.celebahqedge import CelebAHQEdgeDataset
    from cocosnet_tpu_torch.tools import eval_metrics as EM
    from cocosnet_tpu_torch.tools import mask_to_edge as ME
    rs = np.random.RandomState(3)
    # smooth colour fields with noise: 16 images of 128 x 128
    base = rs.rand(16, 8, 8, 3)
    imgs = np.clip(np.kron(base, np.ones((1, 16, 16, 1))) * 200
                   + rs.rand(16, 128, 128, 3) * 55, 0, 255).astype(np.uint8)
    # the extractor's tower at unit signal scale (its seeded random init
    # leaves relu5_2 at zero), the same weights on both devices
    card = EM.vgg_feature_extractor(device="cuda")
    host = EM.vgg_feature_extractor(device="cpu")
    vgg = host.vgg
    condition_weights(vgg, torch.Generator().manual_seed(5), "cpu")
    card.vgg.load_state_dict(vgg.state_dict())
    fc, fh = card(imgs), host(imgs)
    scale = float(np.linalg.norm(fh))
    rel = float(np.linalg.norm(fc - fh)) / max(scale, 1e-30)
    _check(fc.shape == (16, 512) and bool(np.isfinite(fc).all())
           and scale > 0 and rel <= 1e-4,
           f"eval_metrics VGG19 relu5_2 features (16, 512) on the card vs "
           f"the CPU (conditioned random weights; |features| {scale:.4g}): "
           f"relative L2 {rel:.3g} <= 1e-4")
    swd = EM.swd(imgs[:8], imgs[8:])
    fid = EM.fid_from_features(fc[:8], fc[8:])
    _check(bool(np.isfinite(swd["avg"])) and bool(np.isfinite(fid)),
           f"eval_metrics SWD x100 {swd['avg']:.4g} (per level "
           + ", ".join(f"{k}: {v:.4g}" for k, v in swd.items() if k != "avg")
           + f"), FID on the card's features {fid:.4g}, finite")
    tmp = tempfile.mkdtemp(prefix="cocosnet_tools_")
    try:
        root, tables = os.path.join(tmp, "celeb"), os.path.join(tmp, "tables")
        SYN.make_celebahq_tree(root, n_train=4, n_val=8, size=288,
                               block=32, table_dir=tables)
        opt = test_defaults(dataset_mode="celebahqedge", dataroot=root,
                            ref_table_dir=tables, load_size=256,
                            crop_size=256)
        ds = CelebAHQEdgeDataset(opt)
        params = {"crop_pos": (0, 0), "flip": False}
        for idx in range(4):
            stack = ME.build_one(root, idx, 256)
            want = ds.get_label_tensor(ds.imgpath_to_labelpath(
                os.path.join(root, "CelebA-HQ-img", f"{idx}.jpg")), params)
            _check(stack.shape == (256, 256, 15) and stack.dtype == np.uint8
                   and np.array_equal(stack.astype(np.float32) / 255, want),
                   f"mask_to_edge id {idx}: the (256, 256, 15) uint8 stack "
                   f"/ 255 equals celebahqedge's label tensor ("
                   f"{int((stack[..., 0] > 0).sum())} edge pixels)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------- phase 15

# the chunks of phase 15: K = 2 at the small setting (a) and in the
# one-rank NCCL group (d), K = 4 at full width (b) and in the train twin (c)
SMALL_K = 2
FLAGSHIP_K = 4
# the graph's replays against the eager steps on the card from the same
# state (the same kernels on the same inputs in the same order): every loss
# at rel GRAPH_LOSS_TOL (|t| + 1e-2 below), each measure of the state
# (_state_rel) within GRAPH_STATE_TOL. The card's reductions are not
# deterministic run to run: two eager runs of the same two steps differ by
# up to 5e-3 in these measures (printed beside), one step by 1e-4; a
# replay that read a stale input or skipped an update misses by O(1)
GRAPH_LOSS_TOL = 1e-5
GRAPH_STATE_TOL = 1e-2


def _chunk_opt(**kw):
    """Phase 15's small setting: phase 13's (tools/parity_trajectory.py's:
    64 px, batch 2, ngf 64, ndf 16, 12 classes, EMA, TTUR, f32) at
    match_kernel 3 on the shift9 kernels; kw may set match_kernel 1."""
    from cocosnet_tpu_torch.tools import parity_trajectory as PT
    return PT.train_opt("kernels").replace(**{"match_kernel": 3, **kw})


def _chunk_nets(P, opt, device, init):
    """The nets of `opt` on `device` with phase 13's weights (init: the
    (G, Corr, D) state dicts and the VGG's)."""
    from cocosnet_tpu_torch.tools import parity_trajectory as PT
    init_sd, vgg_sd = init
    nets = P.Pix2PixNets(opt, device=device, seed=0)
    for key, name in PT.NETS:
        getattr(nets, name).load_state_dict(init_sd[key])
    nets.vgg.load_state_dict(vgg_sd)
    return nets


def _copy_run(P, TS, nets, state, device):
    """A second (nets, train state) on `device` holding the run's state:
    every net's parameters and buffers, the EMA shadows, both Adam states
    (through train.state.load_optimizer, as a checkpoint loads them), the
    rates, the step counter and, on the same kind of device, the noise
    generator's state."""
    import copy
    nets2 = copy.deepcopy(nets)
    nets2.device = torch.device(device)
    for net in nets2.modules():
        net.to(nets2.device)
    state2 = TS.create_train_state(nets.opt, nets2)
    with torch.no_grad():
        for k, v in (state.ema or {}).items():
            state2.ema[k].copy_(v)
    for side in ("opt_g", "opt_d"):
        TS.load_optimizer(getattr(state2, side),
                          copy.deepcopy(getattr(state, side).state_dict()))
    state2.lrs, state2.step = state.lrs, state.step
    if torch.device(device).type == nets.device.type:
        state2.noise.set_state(state.noise.get_state())
    return nets2, state2


def _run_state(nets, state) -> dict:
    """{part: {name: f32 tensor}} of a run's state, cloned where it lies:
    the trained nets' parameters, spectral u/v and BatchNorm statistics,
    the EMA shadows and Adam's two moments."""
    out = {k: {} for k in ("params", "uv", "stats", "ema", "exp_avg",
                           "exp_avg_sq")}
    names = {}
    for net in TRAINED:
        m = getattr(nets, net)
        for k, p in m.named_parameters():
            out["params"][f"{net}.{k}"] = p.detach().float().clone()
            names[p] = f"{net}.{k}"
        for k, t in m.state_dict().items():
            part = ("uv" if k.endswith(("weight_u", "weight_v")) else
                    "stats" if k.endswith(("running_mean", "running_var"))
                    else None)
            if part:
                out[part][f"{net}.{k}"] = t.float().clone()
    out["ema"] = {k: v.float().clone() for k, v in (state.ema or {}).items()}
    for o in (state.opt_g, state.opt_d):
        for p, st in o.state.items():
            for key in ("exp_avg", "exp_avg_sq"):
                out[key][names[p]] = st[key].float().clone()
    return out


def _state_rel(got: dict, want: dict, start: dict) -> dict:
    """How far one run's state (_run_state) lies from another's, both from
    `start`, each part measured where `want` lies, in f64: the parameter
    and EMA moves as ||got - want|| / ||want - start||, Adam's moments as
    ||got - want|| / ||want||, the spectral u/v as the max abs difference,
    the BatchNorm statistics as the max abs difference over each vector's
    scale."""
    def on(t, like):
        return t.to(like.device, torch.float64)

    def l2(part, base=None):
        num = den = 0.0
        for k, w in want[part].items():
            w = w.double()
            num += float(((on(got[part][k], w) - w) ** 2).sum())
            ref = w if base is None else w - on(base[part][k], w)
            den += float((ref ** 2).sum())
        return (num / den) ** 0.5 if den else 0.0

    out = {"params": l2("params", start), "exp_avg": l2("exp_avg"),
           "exp_avg_sq": l2("exp_avg_sq")}
    if want["ema"]:
        out["ema"] = l2("ema", start)
    out["uv"] = max(float((on(got["uv"][k], w) - w.double()).abs().max())
                    for k, w in want["uv"].items())
    out["stats"] = max((float((on(got["stats"][k], w) - w.double()).abs()
                              .max()) / max(float(w.abs().max()), 1e-3)
                        for k, w in want["stats"].items()), default=0.0)
    return out


def _loss_rel(got: dict, want: dict) -> float:
    """The largest rel |x - t| / (|t| + 1e-2) over the terms and steps of
    two {term: (K,) losses}."""
    return max(float(((torch.as_tensor(got[k]).double().cpu()
                       - torch.as_tensor(want[k]).double().cpu()).abs()
                      / (torch.as_tensor(want[k]).double().cpu().abs()
                         + 1e-2)).max()) for k in want)


def _stacked(rows) -> dict:
    """[{term: 0-d}] of K steps -> {term: (K,)} on the host."""
    return {k: torch.stack([r[k].detach().float().cpu() for r in rows])
            for k in rows[0]}


def _host_losses(losses) -> dict:
    return {k: v.detach().float().cpu() for k, v in losses.items()}


def _fmt_rel(rel: dict) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in rel.items())


def _graph_vs_eager(tag, got_losses, want_losses, got, want, start,
                    control=None):
    """The graph's chunk against the same steps taken eagerly on the card
    from the same state (`start`): GRAPH_LOSS_TOL and GRAPH_STATE_TOL;
    `control`, a second eager run's (losses, state), printed beside: the
    card's own run-to-run spread."""
    rel = _loss_rel(got_losses, want_losses)
    diff = _state_rel(got, want, start)
    spread = ""
    if control is not None:
        spread = (f"; a second eager run against the first: losses rel "
                  f"{_loss_rel(control[0], want_losses):.3g}, "
                  + _fmt_rel(_state_rel(control[1], want, start)))
    _check(rel <= GRAPH_LOSS_TOL and max(diff.values()) <= GRAPH_STATE_TOL,
           f"{tag}: graph replays vs eager steps on the card from the same "
           f"state: losses rel {rel:.3g} <= {GRAPH_LOSS_TOL:g}; the state "
           f"(_state_rel) <= {GRAPH_STATE_TOL:g}: {_fmt_rel(diff)}{spread}")


def _chunk_vs_cpu(tag, got_losses, want_losses, got, want, start):
    """The graph's chunk on the card against the CPU chunk from the same
    state (_state_rel's measures), at phase 3b's bounds and phase 13's
    schedule: the losses of step j at TRAJ_TOLS[j]; each parameter and
    EMA move at 10% relative L2; Adam's first moment, the chunk's last
    gradient (beta1 = 0 under TTUR), at phase 3b's 2e-2 for one step's
    gradient times the schedule's growth to the chunk's last step
    (TRAJ_TOLS[K - 1] / TRAJ_TOLS[0]), its second moment at 4e-2 (a
    square doubles the relative error); the spectral u/v at atol 2e-5;
    the BatchNorm statistics at rel 2e-3 of their scale."""
    k = len(next(iter(want_losses.values())))
    for j in range(k):
        rel = _loss_rel({t: v[j:j + 1] for t, v in got_losses.items()},
                        {t: v[j:j + 1] for t, v in want_losses.items()})
        _check(rel <= TRAJ_TOLS[j], f"{tag}: step {j} of the chunk, graph "
               f"on the card vs the CPU chunk, every loss rel {rel:.3g} <= "
               f"{TRAJ_TOLS[j]:g}")
    grad_tol = 2e-2 * TRAJ_TOLS[k - 1] / TRAJ_TOLS[0]
    bounds = {"params": 0.1, "ema": 0.1, "exp_avg": grad_tol,
              "exp_avg_sq": 4e-2, "uv": 2e-5, "stats": 2e-3}
    rel = _state_rel(got, want, start)
    _check(all(v <= bounds[p] for p, v in rel.items()),
           f"{tag}: the state after the chunk, card vs CPU, each within "
           f"its bound: " + ", ".join(f"{p} {v:.3g} <= {bounds[p]:g}"
                                      for p, v in rel.items()))


def small_chunks(P, TS, ST, init) -> None:
    """Phase 15 (a): make_multi_train_step at the small setting (_chunk_opt,
    f32). The graph's run takes its WARM_UP_STEPS eager steps; its state is
    then copied to a second card run and to the CPU, and from there the
    graph's chunk of SMALL_K on two more batches (the capture, then a
    replay a step) runs against SMALL_K eager card steps (GRAPH_*_TOL) and
    the CPU chunk (_chunk_vs_cpu). Then on each other route (the
    match_kernel 1 kernels, the dW kernel, the fused conv, --remat with
    --mask_noise and --noise_for_mask, --remat --remat_full) a capture and
    one replay against the eager step; on every route the capture call
    launches the route's kernels as the eager step does. init: phase 13's
    weights (the (G, Corr, D) state dicts and the VGG's)."""
    from cocosnet_tpu_torch.tools import parity_trajectory as PT
    batches = PT.make_batches(ST.WARM_UP_STEPS + SMALL_K)
    warm, chunk = batches[:ST.WARM_UP_STEPS], batches[ST.WARM_UP_STEPS:]
    counted = counted_entries()
    routes = {"kernels": ("library", {}, ("attend_shift9",
                                         "attend_shift9_backward")),
              "mk1 kernels": ("kernels", dict(match_kernel=1),
                              ("attend_corr", "attend_corr_backward")),
              "dW kernel": ("dw all", {}, ("conv3x3_dw",)),
              "fused conv": ("fused", {}, ("conv3x3_fused",
                                           "conv3x3_fused_backward")),
              "--remat --mask_noise --noise_for_mask": (
                  "library", dict(remat=True, mask_noise=True,
                                  noise_for_mask=True), ()),
              "--remat --remat_full": ("library", dict(remat=True,
                                                       remat_full=True), ())}
    for route, (switches, kw, kernels) in routes.items():
        tag = f"(a) small chunk, {route}"
        kernels = kernels or ("attend_shift9", "attend_shift9_backward")
        main = route == "kernels"
        opt = _chunk_opt(**kw)
        lr = TS.lrs_for_epoch(opt, 1)
        steps = chunk if main else chunk[:1]
        t = time.perf_counter()
        with train_route(switches):
            nets = _chunk_nets(P, opt, "cuda", init)
            state = TS.create_train_state(opt, nets)
            multi = ST.make_multi_train_step(nets)
            multi(state, warm, lr)                # the eager warm-up steps
            runs = [_copy_run(P, TS, nets, state, "cuda")
                    for _ in range(2 if main else 1)]
            if main:
                cpu = _copy_run(P, TS, nets, state, "cpu")
            start = _run_state(nets, state)
            _zero_counts(counted)
            got, _ = multi(state, steps, lr)      # the capture, replays
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counted.items()}
            eager = []
            for i, (nets2, state2) in enumerate(runs):
                step = ST.make_train_step(nets2)
                _zero_counts(counted)
                losses = _stacked([step(state2, b, lr)[0] for b in steps])
                torch.cuda.synchronize()
                if i == 0:
                    moved = {k: fn.launches for k, fn in counted.items()}
                eager.append((losses, _run_state(nets2, state2)))
            del runs, nets2, state2, step
            n = len(steps)
            _check(all(launches[k] > 0 for k in kernels)
                   and {k: n * v for k, v in launches.items()} == moved,
                   f"{tag}: the capture call launched {launches}; {n} eager "
                   f"step(s) {moved}; {kernels} among them")
            got, graph_state = _host_losses(got), _run_state(nets, state)
            _graph_vs_eager(tag, got, eager[0][0], graph_state, eager[0][1],
                            start, eager[1] if main else None)
            del eager
            if main:
                cpu_losses, _ = ST.make_multi_train_step(cpu[0])(
                    cpu[1], steps, lr)
                _chunk_vs_cpu(tag, got, _host_losses(cpu_losses),
                              graph_state, _run_state(*cpu), start)
                del cpu
        del nets, state, multi, graph_state, start
        torch.cuda.empty_cache()
        print(f"     {tag} took {time.perf_counter() - t:.1f} s", flush=True)


def _event_chunk(fn, k) -> tuple:
    """(ms a step by CUDA events, ms a step by the host clock) of fn(), k
    steps, from a synchronized start to a synchronize."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / k, 1e3 * (time.perf_counter() - t) / k


def flagship_chunk(P, cfg, TS, ST, g) -> None:
    """Phase 15 (b): the flagship mk3 B8 bf16 at K = FLAGSHIP_K in both
    forms from the same state: the graph's run takes its warm-up steps, is
    copied to an eager run, and each takes FLAGSHIP_K steps on the same
    four batches (the graph's: the capture, then a replay a step): every
    loss finite, the first replayed step's loss terms phase 5's and at
    rel 2e-3 of the eager step's, the wrappers' launches on the capture
    call one step's (TRAIN_LAUNCHES), the shift9 launches in the kernel
    records of one replay one step's; then each form times FLAGSHIP_K
    more steps (ms a step: CUDA events over the chunk / K, and the host
    clock), its peak memory, and profiles one replay against one eager
    step (device busy and idle share), all printed side by side."""
    opt = train_opt(cfg, label_nc=150, crop_size=256, load_size=256,
                    batchSize=8, ngf=64, ndf=64)
    lr = TS.lrs_for_epoch(opt, 1)
    batches = [{k: v.cuda() for k, v in make_batch(
        g, 8, 256, 256, opt.semantic_nc).items()}
        for _ in range(ST.WARM_UP_STEPS + FLAGSHIP_K)]
    warm, chunk = batches[:ST.WARM_UP_STEPS], batches[ST.WARM_UP_STEPS:]
    L = sys.modules["cocosnet_tpu_torch.nn.layers"]
    L.set_compute_dtype(torch.bfloat16)
    nets = P.Pix2PixNets(opt, seed=0)
    for net in nets.modules():
        condition_weights(net, g, "cuda")
    state = TS.create_train_state(opt, nets)
    multi = ST.make_multi_train_step(nets)
    multi(state, warm, lr)
    info = {}
    # the eager form first (the graph's pool does not exist yet)
    nets2, state2 = _copy_run(P, TS, nets, state, "cuda")
    step = ST.make_train_step(nets2)
    base = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    eager = [step(state2, b, lr)[0] for b in chunk]
    torch.cuda.synchronize()

    def eager_chunk():
        for b in chunk:
            step(state2, b, lr)
    info["eager"] = dict(zip(("event_ms", "host_ms"),
                             _event_chunk(eager_chunk, FLAGSHIP_K)))
    info["eager"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    info["eager"]["resident_gib"] = base
    rec = profile_call(lambda: step(state2, chunk[0], lr), warmup=False)
    info["eager"]["busy_ms"] = rec and rec["busy_ms"]
    info["eager"]["wall_ms"] = rec and rec["wall_ms"]
    eager = _stacked(eager)
    del nets2, state2, step
    torch.cuda.empty_cache()

    counted = counted_entries()
    _zero_counts(counted)
    base = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    got, vis = multi(state, chunk, lr)           # the capture, replays
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    want = TRAIN_LAUNCHES[(3, "kernels")]
    _check(launches == want, f"(b) flagship chunk: the capture call launched "
           f"{launches}, one step's {want}; the replays launch through the "
           f"graph, past the wrappers' counts")
    got = _host_losses(got)
    _check(set(got) == FLAGSHIP_LOSS_KEYS and all(
        bool(torch.isfinite(v).all()) for v in got.values())
        and tuple(vis["fake_image"].shape) == (8, 256, 256, 3)
        and bool(torch.isfinite(vis["fake_image"]).all()),
        f"(b) flagship chunk of {FLAGSHIP_K}: {len(got)} loss terms, every "
        f"step's finite; the last fake_image (8, 256, 256, 3) finite")
    first = {k: v[:1] for k, v in got.items()}
    rel = _loss_rel(first, {k: v[:1] for k, v in eager.items()})
    _check(rel <= 2e-3, f"(b) the first replayed step vs the eager step from "
           f"the same state: every loss rel {rel:.3g} <= 2e-3: " + ", ".join(
               f"{k} {float(first[k][0]):.5g}/{float(eager[k][0]):.5g}"
               for k in sorted(first)))
    info["graph"] = dict(zip(("event_ms", "host_ms"), _event_chunk(
        lambda: multi(state, chunk, lr), FLAGSHIP_K)))
    info["graph"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    info["graph"]["resident_gib"] = base
    rec = profile_call(lambda: multi(state, chunk[:1], lr), warmup=False)
    _check(rec is not None, "(b) the profiler recorded a replay's kernels")
    info["graph"]["busy_ms"] = rec["busy_ms"]
    info["graph"]["wall_ms"] = rec["wall_ms"]
    one = {"shift9_fwd.cu": want["attend_shift9"],
           "shift9_bwd.cu": want["attend_shift9_backward"]}
    seen = {f: rec["calls"][f] for f in one}
    _check(seen == one, f"(b) one replay's kernel records: shift9_fwd.cu and "
           f"shift9_bwd.cu launched {seen}, one step's {one} (phase 5)")
    for form in ("graph", "eager"):
        r = info[form]
        r["idle"] = 1 - r["busy_ms"] / r["wall_ms"] if r["busy_ms"] else None
    print(f"(b) flagship mk3 B8 bf16, K = {FLAGSHIP_K}, graph | eager: "
          + "; ".join(
              f"{what} {_ms(info['graph'][k])} | {_ms(info['eager'][k])}"
              for what, k in (
                  (f"ms a step, CUDA events over the chunk / {FLAGSHIP_K}",
                   "event_ms"),
                  ("ms a step, host clock", "host_ms"),
                  ("one step's device busy ms", "busy_ms"),
                  ("its host ms", "wall_ms"), ("idle share", "idle"),
                  ("peak GiB", "peak_gib"),
                  ("GiB resident before", "resident_gib"))), flush=True)
    del nets, state, multi, batches, vis
    L.set_compute_dtype(None)
    torch.cuda.empty_cache()


def chunk_twin() -> None:
    """Phase 15 (c): the train twin (cli/train.py) at --steps_per_dispatch
    FLAGSHIP_K on phase 7's flags (batch 8, bf16 policy) and a synthetic
    ADE20k tree of 40 training photos: 5 steps an epoch, a chunk of 4 (two
    warm-up steps, the capture, two replays) and a tail of one step; a
    `latest` save due after 16 images waits for the chunk's end (32), with
    iter.txt there; then --continue_train for a second epoch (no `latest`
    save inside it), captured anew on the loaded state. The wrappers count
    the eager steps and the capture call: 4 steps' launches an epoch."""
    import contextlib
    import io
    import shutil
    import statistics
    import tempfile
    from cocosnet_tpu_torch.cli import train as TTRAIN
    from cocosnet_tpu_torch.data import synthetic as SYN
    L = sys.modules["cocosnet_tpu_torch.nn.layers"]
    base = tempfile.mkdtemp(prefix="cocosnet_chunk_twin_")
    try:
        root = os.path.join(base, "ade")
        SYN.make_ade20k_tree(root, n_train=40, n_val=1)
        ck = os.path.join(base, "checkpoints")
        flags = ["--name", "chunk", "--dataset_mode", "ade20k", "--dataroot",
                 root, "--use_attention", "--maskmix",
                 "--warp_mask_losstype", "direct", "--PONO", "--PONO_C",
                 "--checkpoints_dir", ck, "--output_dir",
                 os.path.join(base, "output"), "--nThreads", "4",
                 "--batchSize", "8", "--niter", "1", "--niter_decay", "0",
                 "--weight_mask", "100.0", "--use_ema",
                 "--vgg_normal_correct", "--save_epoch_freq", "1",
                 "--print_freq", "8", "--display_freq", "1000",
                 "--save_latest_freq", "16",
                 "--steps_per_dispatch", str(FLAGSHIP_K)]
        counted = counted_entries()
        per_step = TRAIN_LAUNCHES[(3, "kernels")]
        step_s = []
        for name, extra in (("chunked", []),
                            ("resumed", ["--continue_train", "--niter",
                                         "2", "--save_latest_freq", "0"])):
            _zero_counts(counted)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                run = TTRAIN.main(flags + extra)
            torch.cuda.synchronize()
            text = out.getvalue()
            print(text, end="", flush=True)
            launches = {k: fn.launches for k, fn in counted.items()}
            want = {k: 4 * n for k, n in per_step.items()}
            lines = [ln for ln in text.splitlines()
                     if ln.startswith("(epoch:")]
            _check(run.g_steps == 5 and launches == want
                   and len(lines) == 5,
                   f"train twin --steps_per_dispatch {FLAGSHIP_K} ({name}): "
                   f"{run.g_steps} steps, a loss line each ({len(lines)}); "
                   f"the wrappers counted 2 warm-up steps, the capture call "
                   f"and the tail step: {launches} == {want}")
            _check(all(v == v and abs(v) < float("inf")
                       for v in run.losses.values()),
                   f"train twin ({name}): last losses finite: " + ", ".join(
                       f"{k} {v:.4g}" for k, v in sorted(run.losses.items())))
            step_s += run.step_seconds[1:]
            if name == "chunked":
                out_lines = text.splitlines()
                at = [i for i, ln in enumerate(out_lines)
                      if ln.startswith("saving the latest model")]
                first = out_lines[at[0]:at[0] + 2] if at else []
                _check(first[:1] == ["saving the latest model (epoch 1, "
                                     "total_steps 32)"]
                       and first[1].startswith("Saved current iteration "
                                               "count"),
                       f"train twin: the `latest` save due at 16 images "
                       f"made at the chunk's end, iter.txt with it: "
                       f"{first}")
        with open(os.path.join(ck, "chunk", "iter.txt")) as f:
            record = f.read().split()
        _check(run.state.step == 10 and record == ["3", "0"],
               f"--continue_train resumed at epoch 2 and took its chunk: "
               f"step {run.state.step} == 10, iter.txt {record} == "
               f"['3', '0']")
        print(f"train twin --steps_per_dispatch {FLAGSHIP_K} batch 8: "
              f"{statistics.median(step_s):.4f} s/step (median of "
              f"{len(step_s)} steps after each run's first: a chunk's "
              f"seconds over its steps, the tail step its own; host clock, "
              f"the loader's wait included)", flush=True)
    finally:
        L.set_compute_dtype(None)
        shutil.rmtree(base, ignore_errors=True)


def nccl_chunk(P, TS, ST, init) -> None:
    """Phase 15 (d): phase 11's one-rank NCCL group (the backend a card a
    rank takes) takes a chunk of SMALL_K through the graph at the small
    setting, against the same steps eagerly in the group (GRAPH_*_TOL);
    mesh.check_capturable passes it."""
    import tempfile

    import torch.distributed as dist

    from cocosnet_tpu_torch import mesh as M
    from cocosnet_tpu_torch.tools import parity_trajectory as PT
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    M.init_process_group(M.backend_for(torch.device("cuda")),
                         "file://" + os.path.join(tmp, "nccl"), 0, 1, 60)
    try:
        M.set_global_mesh(M.create_mesh(1, 1))
        M.check_capturable()
        opt = _chunk_opt()
        lr = TS.lrs_for_epoch(opt, 1)
        batches = PT.make_batches(ST.WARM_UP_STEPS + SMALL_K)
        warm, chunk = batches[:ST.WARM_UP_STEPS], batches[ST.WARM_UP_STEPS:]
        nets = _chunk_nets(P, opt, "cuda", init)
        state = TS.create_train_state(opt, nets)
        multi = ST.make_multi_train_step(nets)
        multi(state, warm, lr)
        nets2, state2 = _copy_run(P, TS, nets, state, "cuda")
        start = _run_state(nets, state)
        got, _ = multi(state, chunk, lr)
        step = ST.make_train_step(nets2)
        want = _stacked([step(state2, b, lr)[0] for b in chunk])
        _check(dist.get_backend() == "nccl", "(d) the group is NCCL's")
        _graph_vs_eager(f"(d) one-rank NCCL group, chunk of {SMALL_K}",
                        _host_losses(got), want, _run_state(nets, state),
                        _run_state(nets2, state2), start)
        del nets, state, multi, nets2, state2
    finally:
        M.shutdown()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


def chunk_graphs(P, cfg, TS, ST) -> None:
    """Phase 15: --steps_per_dispatch, make_multi_train_step's chunk as a
    CUDA graph: (a) small_chunks, (b) flagship_chunk, (c) chunk_twin,
    (d) nccl_chunk."""
    from cocosnet_tpu_torch.tools import parity_trajectory as PT
    init = (PT.make_init_sd(0), PT.make_vgg_sd(7))
    t = time.perf_counter()
    small_chunks(P, TS, ST, init)
    print(f"phase 15 (a) took {time.perf_counter() - t:.0f} s", flush=True)
    t = time.perf_counter()
    flagship_chunk(P, cfg, TS, ST, torch.Generator().manual_seed(15))
    print(f"phase 15 (b) took {time.perf_counter() - t:.0f} s", flush=True)
    t = time.perf_counter()
    chunk_twin()
    print(f"phase 15 (c) took {time.perf_counter() - t:.0f} s", flush=True)
    t = time.perf_counter()
    nccl_chunk(P, TS, ST, init)
    print(f"phase 15 (d) took {time.perf_counter() - t:.0f} s", flush=True)


def kernel_checks(P, cfg, L, C, S, Kc, KB, TC, g, g_widths) -> dict:
    """Phase 2: each kernel against its plain version at the shapes of its
    paths, timed; the inputs drawn from g, those of the shift9 backward at
    the other configurations' warp widths from g_widths (a generator of its
    own: every later check of g draws what it drew before them). Returns
    the kernels' records by name."""
    from cocosnet_tpu_torch.ops import ring as R
    rows = {}
    # pono_c off: the centering of the reference's default norm (no
    # --PONO_C), phase 12's configuration (a)
    for pono_c in (True, False):
        r = check_shift9(S, g, pono_c=pono_c)
        rows["attend_shift9" + ("" if pono_c else " pono_c off")] = r
    # the backward at the flagship training shape (batch 8), then an image
    # width of 128 (a 512 px crop), forward and backward
    for pono_c in (True, False):
        r = check_shift9_bwd(S, g, b=8, h=64, w=64, c=256, d=154,
                             pono_c=pono_c, timed=True)
        rows["attend_shift9_backward"
             + ("" if pono_c else " pono_c off")] = r
    check_shift9_bwd(S, g, b=1, h=128, w=128, c=256, d=154, pono_c=True,
                     timed=False)
    # the backward at the warp widths of the other configurations' training
    # steps (phase 10) at the same shape, timed: D 3 (the colours), 22
    # (celebahq's colours and mask columns), 48 (deepfashion's patches);
    # then the column (cycle) warp's call, the roles of query and key
    # swapped, at D 3 (timed) and 48. Their inputs come from a generator
    # of their own, so every later check draws what it drew before these
    for d in (3, 22, 48):
        rows[f"attend_shift9_backward D{d}"] = check_shift9_bwd(
            S, g_widths, b=8, h=64, w=64, c=256, d=d, pono_c=True,
            timed=True)
    rows["attend_shift9_backward D3 swapped"] = check_shift9_bwd(
        S, g_widths, b=8, h=64, w=64, c=256, d=3, pono_c=True, timed=True,
        swap=True)
    rows["attend_shift9 D3 swapped"] = rows[
        "attend_shift9_backward D3 swapped"].pop("forward")
    check_shift9_bwd(S, g_widths, b=8, h=64, w=64, c=256, d=48,
                     pono_c=True, timed=False, swap=True)
    conv_cases = [
        ("conv3x3_fused", dict(b=6, h=64, w=64, ci=512, co=512, reflect=True,
                               stats=False, label="fused 512->512 @64^2 "
                                                  "reflect")),
        ("conv3x3_fused", dict(b=6, h=64, w=64, ci=151, co=128,
                               reflect=False, stats=False,
                               label="fused 151->128 @64^2 zero ring")),
        ("conv3x3_fused_stats", dict(b=6, h=64, w=64, ci=407, co=407,
                                     reflect=True, stats=True,
                                     label="stats 407->407 @64^2 reflect")),
        ("conv3x3_fused_stats", dict(b=6, h=128, w=128, ci=128, co=256,
                                     reflect=False, stats=True,
                                     label="stats 128->256 @128^2 zero "
                                           "ring")),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for name, kw in conv_cases:
            r = check_conv(C, g, dtype=dtype, **kw)
            # the flagship runs the convs in bf16: its first shape is the row
            if dtype == torch.bfloat16:
                rows.setdefault(name, r)
    for dtype in (torch.float32, torch.bfloat16):
        r = check_onehot(C, g, dtype=dtype)
        if dtype == torch.bfloat16:
            rows["conv3x3_onehot"] = r
    # the reflect ring of the library route's convs at the flagship step's
    # bf16 shapes: the 154-channel label map and the 128-channel
    # activations of up_3's SPADEs at 256^2, and the adaptor's dilated
    # block (p 2) at 64^2, from a generator of their own
    g_ring = torch.Generator().manual_seed(16)
    for suffix, (b, h, w, c, p) in (("", (8, 256, 256, 154, 1)),
                                    (" 128ch", (8, 256, 256, 128, 1)),
                                    (" p2", (8, 64, 64, 256, 2))):
        label = f"reflect ring B{b} {h}^2 C{c} p{p}"
        rows["reflect_ring" + suffix], \
            rows["reflect_ring_backward" + suffix] = check_ring(
                R, g_ring, b=b, h=h, w=w, c=c, p=p, label=label)
    torch.cuda.empty_cache()
    # match_kernel 1: the forward at the inference shape (batch 6), the
    # backward at the training shape (batch 8), then both at N = M = 2500
    # (a 200 px crop: partial query and key tiles)
    rows["attend_corr"] = check_corr(Kc, g, b=6, n=4096, timed=True)
    rows["attend_corr_backward"] = check_corr_bwd(Kc, g, b=8, n=4096,
                                                  timed=True)
    check_corr(Kc, g, b=2, n=2500, timed=False)
    check_corr_bwd(Kc, g, b=2, n=2500, timed=False)
    torch.cuda.empty_cache()
    # the training dW at every shape of the COCOSNET_PALLAS_DW=1 gate (batch
    # 8, both rings, f32 and bf16), timed at its most frequent one (128->512
    # @64^2, 40 calls per step: the row) and at 512->512; the fused conv's
    # backward dx at 512->512
    for dtype in (torch.float32, torch.bfloat16):
        for h, w, ci, co, _ in sorted(C.DW_WINNERS):
            for reflect in (True, False):
                timed = (dtype == torch.bfloat16 and reflect
                         and (ci, co) in ((128, 512), (512, 512)))
                r = check_dw(C, g, b=8, h=h, w=w, ci=ci, co=co,
                             reflect=reflect, dtype=dtype, timed=timed)
                if timed and (ci, co) == (128, 512):
                    rows["conv3x3_dw"] = r
    torch.cuda.empty_cache()
    rows["conv3x3_fused_backward"] = check_fused_bwd(
        C, g, b=8, h=64, w=64, ci=512, co=512, dtype=torch.bfloat16)
    forward_conv_table(P, cfg, L, C, g)
    # the large-descriptor correlation at the A/B tool's shape (batch 6,
    # 64 x 64, C = 9 x 256, D = 3), then a ragged N != M, untimed
    rows["attend_corr_bigc"] = check_bigc(Kc, TC, g, b=6, n=4096, m=4096,
                                          timed=True)
    rows["attend_corr_bigc_backward"] = check_bigc_bwd(
        Kc, KB, TC, g, b=6, n=4096, m=4096, timed=True)
    check_bigc(Kc, TC, g, b=2, n=2500, m=2304, timed=False)
    check_bigc_bwd(Kc, KB, TC, g, b=2, n=2500, m=2304, timed=False)
    torch.cuda.empty_cache()
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        _fail("no CUDA device: this smoke test runs only on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cocosnet_tpu_torch import config as cfg
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.nn import layers as L
    from cocosnet_tpu_torch.ops import _build
    from cocosnet_tpu_torch.ops import conv3x3 as C
    from cocosnet_tpu_torch.ops import corr as Kc
    from cocosnet_tpu_torch.ops import corr_bigc as KB
    from cocosnet_tpu_torch.ops import correlation as TC
    from cocosnet_tpu_torch.ops import shift9 as S
    from cocosnet_tpu_torch.train import state as TS
    from cocosnet_tpu_torch.train import steps as ST

    # phase 1: environment and build
    print(card_line(), flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t_start = t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    _phase_done(1, t_start)

    # phase 2: each kernel against its plain version at flagship shapes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    rows = kernel_checks(P, cfg, L, C, S, Kc, KB, TC, g,
                         torch.Generator().manual_seed(12))
    _phase_done(2, t_start)

    # phase 3: the small-input slices against the plain versions
    for mk in (3, 1):
        reference_check(P, cfg, g, mk)
    # phase 3b: small f32 train steps against the plain versions, computed
    # once a match_kernel on its first route
    refs = {}
    for mk, route in ((3, "kernels"), (1, "library"), (1, "kernels"),
                      (3, "dw all"), (3, "fused")):
        with train_route(route):
            if mk not in refs:
                opt = small_train_opt(cfg, match_kernel=mk)
                refs[mk] = cpu_train_reference(
                    P, L, TS, ST, g, opt,
                    make_batch(g, 1, 128, 256, opt.semantic_nc))
            train_reference_check(P, L, TS, ST, refs[mk],
                                  f"match_kernel {mk} ({route} route)",
                                  _corr_launches(mk, route), route)
        torch.cuda.empty_cache()
    del refs
    _phase_done(3, t_start)

    # phases 4 and 4b: flagship-width inference, bf16 policy
    phase4, phase5 = {}, {}
    runs = {"inference": flagship_inference(P, cfg, L, g, 3, 10, phase4),
            "match_kernel 1 inference": flagship_inference(P, cfg, L, g, 1,
                                                           10)}
    _phase_done(4, t_start)
    # phases 5 and 5b: flagship-width training, bf16 policy
    runs["train step"] = flagship_training(P, cfg, TS, ST, g, 3, "kernels",
                                           2, phase5)
    # (each route times 2 steps: 5 before phase 10 came, and 3 before
    # phase 15 came: the script's time)
    for route in ("library", "kernels"):
        with train_route(route):
            runs[f"match_kernel 1 train step, {route} route"] = \
                flagship_training(P, cfg, TS, ST, g, 1, route, 2)
    # phases 5c and 5d: the flagship train step on its two conv routes
    for route, path in (("dw", "train step, COCOSNET_PALLAS_DW=1"),
                        ("fused", "train step, COCOSNET_FUSED_CONV_TRAIN=1")):
        with train_route(route):
            runs[path] = flagship_training(P, cfg, TS, ST, g, 3, route, 2)
    L.set_compute_dtype(None)
    _phase_done(5, t_start)

    # phase 6: the tool twins at their defaults; bench_corr is the path of
    # the large-descriptor kernels
    from cocosnet_tpu_torch.tools import ab_dw, bench_corr
    print("tools/ab_dw.py twin:", flush=True)
    ab_dw.main([])
    counted = counted_entries()
    _zero_counts(counted)
    print("tools/bench_corr.py twin:", flush=True)
    bench = bench_corr.main([])
    _check(all(r["err"] <= 5e-4 for r in bench),
           "bench_corr: every path within 5e-4 of the f32 oracle: "
           + ", ".join(f"{r['path']} {r['err']:.2e}" for r in bench))
    runs["bench_corr"] = {k: fn.launches for k, fn in counted.items()}
    _check(runs["bench_corr"]["attend_corr_bigc"] > 0
           and runs["bench_corr"]["attend_corr_bigc_backward"] > 0,
           f"bench_corr launched the large-descriptor kernels "
           f"{runs['bench_corr']}")
    _phase_done(6, t_start)

    # phase 7: the command-line twins on a synthetic ADE20k tree
    entry_twins(L)
    _phase_done(7, t_start)

    # phase 8: the serving path: the forward as a CUDA graph, the serve
    # twin's files, bench_serve against it
    captures = serving(P, cfg, L, g)
    _phase_done(8, t_start)
    serve_launches = {k: captures[(3, 6)][k] or captures[(1, 6)][k]
                      for k in captures[(3, 6)]}

    # phase 9: the three other published inference configurations
    config_rows = published_configs(P, cfg, L, C, S, g)
    _phase_done(9, t_start)

    # phase 10: the training of the three other published configurations
    runs.update(config_trainings(P, cfg, L, TS, ST, g))
    _phase_done(10, t_start)

    # phase 11: data and spatial parallelism. The rectangular shift9
    # kernels at the 512 px shards of 2 and 4 model ranks (and the column
    # warp's call, roles swapped), then two processes sharing the card over
    # gloo: the SP inference and train step at mesh_model 2, the train
    # step at mesh_data 2, each against one process; a one-rank NCCL group
    t11 = time.perf_counter()
    g_sp = torch.Generator().manual_seed(13)
    square = square_b1_ms(S, g_sp)
    for m in (2, 4):
        for swap in (False, True):
            tag = f" SP m{m}" + (" swapped" if swap else "")
            rows["attend_shift9" + tag], rows["attend_shift9_backward" + tag] \
                = check_shift9_rect(S, g_sp, m=m, swap=swap, square=square)
    print(f"phase 11 kernels done in {time.perf_counter() - t11:.0f} s",
          flush=True)
    sp = parallelism(P, cfg, TS, ST)
    runs["SP inference, mesh_model 2"] = sp["infer"]
    runs["SP train step, mesh_model 2"] = sp["train"]
    print(f"phase 11 took {time.perf_counter() - t11:.0f} s", flush=True)
    _phase_done(11, t_start)

    # phase 12: the architecture branches off the flagship (the reference's
    # default BatchNorm norm, the extras, remat, the explicit matrix)
    branch_runs, row_410 = architecture_branches(
        P, cfg, L, C, TS, ST, torch.Generator().manual_seed(14))
    runs.update(branch_runs)
    _phase_done(12, t_start)

    # phase 13: the training trajectory (card against CPU, then TRAJ_STEPS
    # steps of three routes on the card)
    t13 = time.perf_counter()
    runs["trajectory, kernels route (4 steps)"] = trajectory()
    print(f"phase 13 took {time.perf_counter() - t13:.0f} s", flush=True)
    _phase_done(13, t_start)

    # phase 14: the profile twins, eval_metrics and mask_to_edge
    t14 = time.perf_counter()
    profile_twins(phase4, phase5)
    print(f"phase 14 profile twins took {time.perf_counter() - t14:.0f} s",
          flush=True)
    tool_twins()
    print(f"phase 14 took {time.perf_counter() - t14:.0f} s", flush=True)
    _phase_done(14, t_start)

    # phase 15: --steps_per_dispatch, the chunk of fused steps as one CUDA
    # graph replayed a step at a time
    t15 = time.perf_counter()
    chunk_graphs(P, cfg, TS, ST)
    print(f"phase 15 took {time.perf_counter() - t15:.0f} s", flush=True)
    _phase_done(15, t_start)

    # per kernel: its source, the TPU kernel it replaces, and the main path
    # whose run counts its launches (the path it came in with)
    src = {"attend_shift9": ("cocosnet_tpu_torch/csrc/shift9_fwd.cu",
                             "cocosnet_tpu/ops/pallas_shift9.py:173",
                             "inference"),
           "attend_shift9_backward": ("cocosnet_tpu_torch/csrc/shift9_bwd.cu",
                                      "cocosnet_tpu/ops/pallas_shift9.py:302",
                                      "train step"),
           "conv3x3_fused": ("cocosnet_tpu_torch/csrc/conv3x3.cu",
                             "cocosnet_tpu/ops/pallas_conv.py:174",
                             "inference"),
           "conv3x3_fused_stats": ("cocosnet_tpu_torch/csrc/conv3x3.cu",
                                   "cocosnet_tpu/ops/pallas_conv.py:174",
                                   "inference"),
           "conv3x3_onehot": ("cocosnet_tpu_torch/csrc/conv3x3_onehot.cu",
                              "cocosnet_tpu/ops/pallas_conv.py:808",
                              "inference"),
           "attend_corr": ("cocosnet_tpu_torch/csrc/corr_fwd.cu",
                           "cocosnet_tpu/ops/pallas_corr.py:113",
                           "match_kernel 1 inference"),
           "attend_corr_backward": (
               "cocosnet_tpu_torch/csrc/corr_bwd.cu",
               "cocosnet_tpu/ops/pallas_corr.py:202",
               "match_kernel 1 train step, kernels route"),
           "conv3x3_dw": ("cocosnet_tpu_torch/csrc/conv3x3_dw.cu",
                          "cocosnet_tpu/ops/pallas_conv.py:432",
                          "train step, COCOSNET_PALLAS_DW=1"),
           "conv3x3_fused_backward": (
               "cocosnet_tpu_torch/csrc/conv3x3.cu",
               "cocosnet_tpu/ops/pallas_conv.py:267",
               "train step, COCOSNET_FUSED_CONV_TRAIN=1"),
           "attend_corr_bigc": ("cocosnet_tpu_torch/csrc/corr_fwd.cu",
                                "cocosnet_tpu/ops/pallas_corr_bigc.py:98",
                                "bench_corr"),
           "attend_corr_bigc_backward": (
               "cocosnet_tpu_torch/csrc/corr_bwd.cu",
               "cocosnet_tpu/ops/pallas_corr_bigc.py:194", "bench_corr")}
    # serve_launches: the capture call's, of the serve graph at mk3 B6 (at
    # mk1 B6 for the mk1 correlation)
    kernels = [dict(name=k, route="cuda", source=source, replaces=replaces,
                    path=path, launches=runs[path][k],
                    serve_launches=serve_launches[k], **rows[k])
               for k, (source, replaces, path) in src.items()]
    # phase 9's rows: the shift9 forward at the other configurations' warp
    # widths, and their residual stacks' statistics conv
    kernels += [dict(route="cuda", source=src[r["name"].split()[0]][0],
                     replaces=src[r["name"].split()[0]][1], **r)
                for r in config_rows]
    # phase 2's backward rows at the other configurations' warp widths, and
    # the column warp's call (roles swapped), with the launches of the
    # phase 10 step that runs them (per step: celebahq D 22 and D 3,
    # celebahqedge D 3 twice, the second swapped, deepfashion D 48)
    for name, path in (
            ("attend_shift9_backward D22", "celebahq train step"),
            ("attend_shift9_backward D3", "celebahqedge train step"),
            ("attend_shift9_backward D3 swapped", "celebahqedge train step"),
            ("attend_shift9_backward D48", "deepfashion train step")):
        kernels.append(dict(
            name=name, route="cuda",
            source=src["attend_shift9_backward"][0],
            replaces=src["attend_shift9_backward"][1], path=path,
            launches=runs[path]["attend_shift9_backward"], **rows[name]))
    # phase 11's rows: the rectangular kernels at the SP shards, with the
    # launches a model rank made of each in the 512 px inference (the
    # forward) and the train step (the backward) at mesh_model 2
    for m in (2, 4):
        for swap in ("", " swapped"):
            for base, path in (
                    ("attend_shift9", "SP inference, mesh_model 2"),
                    ("attend_shift9_backward", "SP train step, mesh_model 2")):
                name = f"{base} SP m{m}{swap}"
                kernels.append(dict(
                    name=name, route="cuda", source=src[base][0],
                    replaces=src[base][1], path=path,
                    launches=runs[path][base], **rows[name]))
    # phase 12's rows: the shift9 pair at pono_c off (phase 2) with the
    # launches of configuration (a)'s forward and step; the column warp's
    # forward (phase 2) with celebahqedge's step (row and column warp at D
    # 3); the coordconv stack's statistics conv of (b)'s forward table,
    # with its count in that forward
    for name, base, path in (
            ("attend_shift9 pono_c off", "attend_shift9", "(a) inference"),
            ("attend_shift9_backward pono_c off", "attend_shift9_backward",
             "(a) train step"),
            ("attend_shift9 D3 swapped", "attend_shift9",
             "celebahqedge train step")):
        kernels.append(dict(name=name, route="cuda", source=src[base][0],
                            replaces=src[base][1], path=path,
                            launches=runs[path][base], **rows[name]))
    # the reflect ring (no TPU kernel: the JAX package pads in XLA) with
    # the launches of the flagship train step (p 1) and of the serve
    # graph's capture call, and the dilated adaptor's row (p 2) with those
    # of (b)'s step without --remat
    for suffix, path, p in (("", "train step", 1),
                            (" 128ch", "train step", 1),
                            (" p2", "(b) extras B8 training", 2)):
        for base in RING_ENTRIES:
            kernels.append(dict(
                name=base + suffix, route="cuda",
                source="cocosnet_tpu_torch/csrc/reflect_ring.cu",
                replaces=None, path=path,
                launches=runs[path].get(f"{base} p{p}", 0),
                serve_launches=serve_launches[base] if p == 1 else 0,
                **rows[base + suffix]))
    kernels.append(dict(
        name="conv3x3_fused_stats 410->410 @64^2", route="cuda",
        source=src["conv3x3_fused_stats"][0],
        replaces=src["conv3x3_fused_stats"][1], path="(b) inference",
        launches=row_410["count"], **{k: row_410[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}))
    print(f"chip_smoke.py ran in {time.perf_counter() - t_start:.0f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
