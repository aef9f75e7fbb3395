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
checking on each path that every kernel of that path was launched as often
as the routing predicts.

    python3 chip_smoke.py

Prints the card's name and power limit, one line per check, a `kernels`
JSON line (per kernel: its main path and its launches there, max error
against its plain version, its time, the plain version's, the library
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

import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

import torch

# published peaks of one H100 SXM (dense): bytes/s of HBM3, f32 FLOP/s
# outside the tensor cores, bf16 and TF32 FLOP/s on the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
TF32_FLOP_S = 495e12
# tensor-core passes per product of a split-precision product: 3xTF32 (what
# the correlation kernels issue, csrc/tc_split.cuh) or bf16x3 (the split of
# the TPU kernels, pallas_shift9._dot3 and pallas_corr._dot, and the
# cheapest that holds the dense correlation's tolerances,
# tests/test_torch_corr_split.py)
SPLIT_PASSES = 3
TIMED_RUNS = 25


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _check(ok: bool, msg: str) -> None:
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        sys.exit(1)


def time_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median over `runs` CUDA-event-timed calls, after two warm-ups."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, keys, runs: int = 10) -> dict:
    """Device time per call of `fn`'s kernels whose names hold each of
    `keys`, from torch.profiler over `runs` calls after a warm-up: the
    launches' own time, without the host's time between them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(keys, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for k in keys:
                if k in e.name:
                    us[k] += e.time_range.elapsed_us()
    return {k: v / runs / 1e3 for k, v in us.items()}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(nbytes: int, ops: float, rate: float):
    """(least time in ms, what bounds it) for moving nbytes once and doing
    `ops` operations at `rate` per second."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _maxerr(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _outs(r):
    return r if isinstance(r, tuple) else (r,)


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
    flops = 2.0 * b * h * w * 9 * ci * co
    nb = _nbytes(x, k, bias) + b * h * w * co * x.element_size()
    bms, by = bound_ms(nb, flops, BF16_FLOP_S if dtype == torch.bfloat16
                       else F32_FLOP_S)
    print(f"     {label} {dtype}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, F.conv2d {library_ms:.3f} ms, bound {bms:.3f} ms ({by})",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


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
    bms, by = bound_ms(nb, 9.0 * b * h * w * co, F32_FLOP_S)
    print(f"     onehot {dtype}: kernel {ms:.3f} ms (the gather alone "
          f"{gather_ms:.3f}; device time of the gather "
          f"{dev_ms['onehot::onehot_kernel']:.4f} and of the moments "
          f"launch {dev_ms['onehot::moments_kernel']:.4f}; torch's "
          f"reduction of the same partials {torch_ms:.3f}), plain "
          f"{plain_ms:.3f} ms, F.conv2d(dense one-hot) {library_ms:.3f} ms, "
          f"bound {bms:.3f} ms ({by}); {nb / ms / 1e6:.0f} GB/s", flush=True)
    return dict(max_abs_err=errs[0], ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


def check_shift9(S, g, *, pono_c):
    dev = "cuda"
    b, h, w, c, d = 6, 64, 64, 256, 154
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
           f"shift9 B6 64x64 C256 D154 pono_c={pono_c}: o err {err:.3g} <= "
           f"1e-4, lse err {lerr:.3g} <= 1e-3")
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
    flops = 2.0 * b * n * n * (3 * c + d)
    nb = _nbytes(f3, g3, v, qv, kv) + b * n * (d + 1) * 4
    bms, by, tf32_ms, fma_ms = tc_bound(nb, flops)
    issued = _shift9_fwd_issued(b, n, 3 * c, d)
    del f3, g3, qv, kv
    torch.cuda.empty_cache()
    lib = shift9_yardstick(f, gg, v, pono_c, o)
    print(f"     shift9 pono_c={pono_c}: kernel {ms:.3f} ms (device time "
          f"of the flash launch "
          f"{dev_ms['shift9_fwd::shift9_fwd_kernel']:.3f}, of the combine "
          f"{dev_ms['shift9_fwd::shift9_fwd_combine_kernel']:.3f}; with the "
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


def check_shift9_bwd(S, g, *, b, h, w, c, d, pono_c, timed):
    """The forward and the backward kernel on one input against their
    plain versions (the backward from the kernel forward's lse and a random
    output gradient); with `timed`, the record of the backward."""
    dev = "cuda"
    f = torch.randn(b, h, w, c, generator=g).to(dev)
    gg = (torch.randn(b, h, w, c, generator=g) * 1.5 + 0.2).to(dev)
    n = h * w
    v = torch.rand(b, n, d, generator=g).to(dev) * 2 - 1
    go = torch.randn(b, n, d, generator=g).to(dev)
    f3, g3, qv, kv = S.shift9_inputs(f, gg, 0.01, pono_c)
    o, lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    po, plse = S.shift9_core_plain(f3, g3, v, qv, kv, w)
    torch.cuda.synchronize()
    label = f"shift9 B{b} {h}x{w} C{c} D{d} pono_c={pono_c}"
    err, lerr = _maxerr(o, po), _maxerr(lse, plse)
    _check(err <= 1e-4 and lerr <= 1e-3,
           f"{label} forward: o err {err:.3g} <= 1e-4, lse err {lerr:.3g} "
           f"<= 1e-3")
    del po, plse
    dd = (go * o).sum(-1)
    args = (f3, g3, v, qv, kv, lse, go, dd, w)
    got = S.shift9_bwd_kernel(*args)
    want = S.shift9_bwd_plain(*args)
    torch.cuda.synchronize()
    errs, scales = [], []
    for a, r in zip(got, want):
        errs.append(_maxerr(a, r))
        scales.append(float(r.abs().max()))
    del want
    torch.cuda.empty_cache()
    _check(all(e <= BWD_REL_TOL * s for e, s in zip(errs, scales)),
           f"{label} backward: max err / max |out| "
           + ", ".join(f"{nm} {e:.3g}/{s:.3g}"
                       for nm, e, s in zip(BWD_NAMES, errs, scales))
           + f" <= {BWD_REL_TOL:g} (f32 sums reordered, 1/tau in the logits)")
    if not timed:
        return None
    fwd_ms = time_ms(lambda: S.shift9_core_kernel(f3, g3, v, qv, kv, w))
    rate = SPLIT_PASSES * _shift9_fwd_issued(b, n, 3 * c, d) / fwd_ms / 1e9
    print(f"     shift9 forward B{b} pono_c={pono_c}: kernel {fwd_ms:.3f} ms "
          f"in {S.shift9_fwd_parts(b, n, d, f3.device)} key parts, "
          f"{rate:.1f} TFLOP/s of TF32", flush=True)
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
    flops = 2.0 * b * n * n * (3 * c3 + 2 * d)
    issued = _shift9_bwd_issued(b, n, c3, d)
    nb = _nbytes(f3, g3, v, qv, kv, lse, go, dd, *got)
    bms, by, tf32_ms, fma_ms = tc_bound(nb, flops)
    print(f"     shift9 backward pono_c={pono_c}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, {lib['library']} {lib['library_ms']:.3f} ms "
          f"(+ descriptors {lib['prep_ms']:.3f} ms), bound {bms:.3f} ms "
          f"({by}: {flops / 1e9:.1f} GFLOP x {SPLIT_PASSES} bf16 passes; "
          f"3xTF32 {tf32_ms:.3f} ms; f32 FMA {fma_ms:.3f} ms); the tiles "
          f"issue {issued / 1e9:.1f} GFLOP per pass, "
          f"{SPLIT_PASSES * issued / ms / 1e9:.1f} TFLOP/s of TF32",
          flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib["library_ms"],
                library=lib["library"], tf32x3_bound_ms=tf32_ms,
                fma_bound_ms=fma_ms)


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
    flops = 2.0 * b * n * n * (256 + 154)
    issued = _corr_fwd_issued(b, n, n, 256, 154)
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


def tc_bound(nb: int, flops: float):
    """(least time in ms, what bounds it, the 3xTF32 bound in ms, the
    f32-FMA bound in ms) of a correlation kernel's `flops`: the least time
    is that of the split the TPU kernels multiply in, bf16x3 (SPLIT_PASSES
    tensor-core passes at the bf16 rate); beside it the split the CUDA
    kernels issue, 3xTF32 (as many passes at the TF32 rate), and the same
    flops at the f32 FMA rate, the bound of a design without tensor
    cores."""
    bms, by = bound_ms(nb, SPLIT_PASSES * flops, BF16_FLOP_S)
    return (bms, by, bound_ms(nb, SPLIT_PASSES * flops, TF32_FLOP_S)[0],
            bound_ms(nb, flops, F32_FLOP_S)[0])


def _up(x, t):
    return -(-x // t) * t


def _shift9_bwd_issued(b, n, c3, d):
    """The flops csrc/shift9_bwd.cu issues per pass: S3 and dP on the
    128-square regions of the 124-square tiles that cover N padded to 128,
    over 3C and D padded to 32-wide chunks, then dF3 and dG3 over 3C padded
    to 128-column tiles and dV over D padded to 96-column tiles (32 where D
    <= 32), all over N padded to 128."""
    npad = _up(n, 128)
    region = _up(npad, 124) // 124 * 128
    return (2.0 * b * region * region * (_up(c3, 32) + _up(d, 32))
            + 2.0 * b * npad * npad * (2 * _up(c3, 128)
                                       + _up(d, 96 if d > 32 else 32)))


def _shift9_fwd_issued(b, n, c3, d):
    """The flops csrc/shift9_fwd.cu issues per pass: S3 over 3C padded to
    32-wide chunks and P V over D padded to its chunks (8, 32 or 160
    columns, S3 again for each chunk), on 128-row query regions of
    126-query tiles and 64-column key regions of 62-key ones."""
    dch = 8 if d <= 8 else 32 if d <= 32 else 160
    rows, cols = -(-n // 126) * 128, -(-n // 62) * 64
    return 2.0 * b * rows * cols * -(-d // dch) * (_up(c3, 32) + dch)


def _corr_fwd_issued(b, n, m, c, d):
    """The flops csrc/corr_fwd.cu issues per pass: S over C padded to
    32-wide chunks and P v over D padded to its chunks (8, 32 or 160
    columns), over N padded to 128 and M to 64."""
    dch = 8 if d <= 8 else 32 if d <= 32 else 160
    return 2.0 * b * _up(n, 128) * _up(m, 64) * (_up(c, 32) + _up(d, dch))


def _issued_flops(b, n, m, c, d, dv_cols):
    """The flops the correlation backward kernels issue per pass: the
    scores over C and over D padded to 32-wide chunks, dq and dk over C
    padded to 128-column tiles, dv over D padded to its dv_cols-column
    tiles, all over N and M padded to 128-row tiles."""
    def up(x, t):
        return -(-x // t) * t
    npad, mpad = up(n, 128), up(m, 128)
    return 2.0 * b * npad * mpad * (up(c, 32) + up(d, 32) + 2 * up(c, 128)
                                    + up(d, dv_cols))


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
    flops = 2.0 * b * n * n * (3 * 256 + 2 * 154)
    issued = _issued_flops(b, n, n, 256, 154, 96)
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
    flops = 2.0 * b * h * w * 9 * ci * co
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
    flops = 2.0 * b * h * w * 9 * ci * co
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
    flops = 2.0 * b * n * m * (BIGC_C + BIGC_D)
    issued = _corr_fwd_issued(b, n, m, BIGC_C, BIGC_D)
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
    flops = 2.0 * b * n * m * (3 * c + 2 * d)
    issued = _issued_flops(b, n, m, c, d, 32)
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

def _counted():
    """The kernel entries of the paths, by name."""
    from cocosnet_tpu_torch.ops import conv3x3 as C
    from cocosnet_tpu_torch.ops import corr as Kc
    from cocosnet_tpu_torch.ops import corr_bigc as KB
    from cocosnet_tpu_torch.ops import shift9 as S
    return {"attend_shift9": S.attend_shift9,
            "attend_shift9_backward": S.attend_shift9_backward,
            "attend_corr": Kc.attend_corr,
            "attend_corr_backward": Kc.attend_corr_backward,
            "attend_corr_bigc": KB.attend_corr_bigc,
            "attend_corr_bigc_backward": KB.attend_corr_bigc_backward,
            "conv3x3_fused": C.conv3x3_fused,
            "conv3x3_fused_backward": C.conv3x3_fused_backward,
            "conv3x3_fused_stats": C.conv3x3_fused_stats,
            "conv3x3_onehot": C.conv3x3_onehot,
            "conv3x3_dw": C.conv3x3_dw}


def _launches(**kw) -> dict:
    """Launches per forward or step: the named counts, every other 0."""
    return {k: kw.get(k, 0) for k in _counted()}


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
TRAIN_LAUNCHES = {(3, "kernels"): _launches(**SHIFT9),
                  (1, "library"): _launches(),
                  (1, "kernels"): _launches(attend_corr=1,
                                            attend_corr_backward=1),
                  (3, "dw"): _launches(conv3x3_dw=70, **SHIFT9),
                  (3, "fused"): _launches(conv3x3_fused=128,
                                          conv3x3_fused_backward=106,
                                          **SHIFT9)}


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
    key = (match_kernel, route if match_kernel == 1 else "kernels")
    return {k: v for k, v in TRAIN_LAUNCHES[key].items()
            if k.startswith("attend")}


def _zero_counts(counted) -> None:
    for fn in counted.values():
        fn.launches = 0


def condition_weights(module, g, dev) -> None:
    """Random weights at unit signal scale from generator g: conv weights
    at 1/sqrt(fan_in), biases at 0.1, PReLU 0.2, attention gate 0.5, and
    spectral u/v set to the leading singular vectors by power iteration,
    so sigma is the spectral norm (the init leaves u/v random, sigma near
    0 and the activations far from unit scale)."""
    from cocosnet_tpu_torch.nn.blocks import Attention
    from cocosnet_tpu_torch.nn.layers import Conv2d, PReLU
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv2d):
                w = m.weight if m.weight_norm is None else m.weight_orig
                w.copy_((torch.randn(w.shape, generator=g)
                         * w[0].numel() ** -0.5).to(dev))
                if m.bias is not None:
                    m.bias.copy_((torch.randn(m.bias.shape, generator=g)
                                  * 0.1).to(dev))
                if m.weight_norm == "spectral":
                    wm = w.reshape(w.shape[0], -1)
                    u = m.weight_u
                    for _ in range(50):
                        v = torch.nn.functional.normalize(wm.t() @ u, dim=0)
                        u = torch.nn.functional.normalize(wm @ v, dim=0)
                    m.weight_u.copy_(u)
                    m.weight_v.copy_(v)
            elif isinstance(m, PReLU):
                m.weight.fill_(0.2)
            elif isinstance(m, Attention):
                m.gamma.fill_(0.5)


def make_batch(g, b, h, w, nc):
    return {
        "label": torch.randint(0, nc, (b, h, w, 1), generator=g).float(),
        "image": torch.rand(b, h, w, 3, generator=g) * 2 - 1,
        "ref": torch.rand(b, h, w, 3, generator=g) * 2 - 1,
        "label_ref": torch.randint(0, nc, (b, h, w, 1), generator=g).float(),
        "self_ref": torch.ones(b),
    }


def reference_check(P, cfg, g, match_kernel):
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
    opt = cfg.test_defaults(
        dataset_mode="ade20k", label_nc=12, contain_dontcare_label=True,
        crop_size=256, load_size=256, aspect_ratio=2.0, batchSize=1, ngf=16,
        use_attention=True, maskmix=True, PONO=True, PONO_C=True,
        warp_mask_losstype="direct", match_kernel=match_kernel,
        isTrain=False)
    batch = make_batch(g, 1, 128, 256, opt.semantic_nc)
    cpu = P.Pix2PixNets(opt, device="cpu", seed=1)
    condition_weights(cpu.corr, g, "cpu")
    condition_weights(cpu.gen, g, "cpu")
    gpu = P.Pix2PixNets(opt, device="cuda", seed=1)
    gpu.corr.load_state_dict(cpu.corr.state_dict())
    gpu.gen.load_state_dict(cpu.gen.state_dict())
    want = P.inference(cpu, P.preprocess_input(opt, batch, device="cpu"))
    counted = _counted()
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
        f"match_kernel {match_kernel} small input launched {moved} == "
        f"{predicted}, the routing's prediction, the correlation kernel and "
        f"both dense conv kernels among them")
    for key in ("fake_image", "warp_out", "warp_mask"):
        err = _maxerr(got[key].cpu(), want[key])
        _check(err <= 5e-4, f"match_kernel {match_kernel} small-input slice "
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


def term_gradients(P, L, nets, batch) -> dict:
    """{(net, loss term): [gradient of each parameter], f64 on the CPU} of
    one train-mode forward as the train step runs it: each G-side term on
    gen and on corr, each D term (on the detached fake) on disc, by its own
    backward pass."""
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
    return grads


def train_reference_check(P, cfg, L, TS, ST, g, match_kernel, route):
    """The train step's gradients and two f32 train steps on the card (on
    `route`: at match_kernel 1 "kernels" or "library" for the correlation,
    library convs; at match_kernel 3 "kernels", library convs, or a conv
    route, "dw all" or "fused") against the same weights and batch through
    the plain versions on the CPU, at reference_check's size (128 x 256,
    ngf 16, ndf 16, 13 classes, batch 1: a size where the conv gates take
    some convs, so the conv routes' counters move):
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
    opt = train_opt(cfg, label_nc=12, crop_size=256, load_size=256,
                    aspect_ratio=2.0, batchSize=1, ngf=16, ndf=16,
                    match_kernel=match_kernel)
    tag = f"match_kernel {match_kernel} ({route} route)"
    batch = make_batch(g, 1, 128, 256, opt.semantic_nc)
    cpu = P.Pix2PixNets(opt, device="cpu", seed=1)
    for net in cpu.modules():
        condition_weights(net, g, "cpu")
    gpu = P.Pix2PixNets(opt, device="cuda", seed=1)
    for a, b in zip(cpu.modules(), gpu.modules()):
        b.load_state_dict(a.state_dict())
    # the forward advances the spectral u/v: both nets restart from here
    start = [{k: v.clone() for k, v in m.state_dict().items()}
             for m in cpu.modules()]
    want_g = term_gradients(P, L, cpu, batch)
    got_g = term_gradients(P, L, gpu, batch)
    rels = {}
    for key in sorted(want_g):
        num = sum(float(((a - b) ** 2).sum())
                  for a, b in zip(got_g[key], want_g[key]))
        den = sum(float((b ** 2).sum()) for b in want_g[key])
        rels[key] = (num / den) ** 0.5 if den else (0.0 if num == 0
                                                     else 1.0)
    _check(max(rels.values()) <= 2e-2,
           f"{tag} each loss term's gradient on each network, card vs CPU, "
           f"relative L2 <= 2e-2: " + ", ".join(
               f"{term}/{net} {r:.2g}" for (net, term), r in rels.items()))
    del want_g, got_g
    for sd, a, b in zip(start, cpu.modules(), gpu.modules()):
        a.load_state_dict(sd)
        b.load_state_dict(sd)
    p0 = _params(cpu)
    lr = TS.lrs_for_epoch(opt, 1)
    cstate, gstate = TS.create_train_state(opt, cpu), \
        TS.create_train_state(opt, gpu)
    cstep, gstep = ST.make_train_step(cpu), ST.make_train_step(gpu)
    want, _ = cstep(cstate, batch, lr)
    counted = _counted()
    _zero_counts(counted)
    res = []
    records = AB.record_convs(lambda: res.append(gstep(gstate, batch, lr)))
    got = res[0][0]
    torch.cuda.synchronize()
    moved = {k: fn.launches for k, fn in counted.items()}
    want_moved = _launches(**_corr_launches(match_kernel, route),
                           **AB.predicted_launches(records))
    _check(moved == want_moved,
           f"{tag} small train step launched {moved} == {want_moved}, the "
           f"routing's prediction")
    new = {"dw all": ("conv3x3_dw",),
           "fused": ("conv3x3_fused", "conv3x3_fused_backward")}.get(route,
                                                                    ())
    _check(all(moved[k] for k in new), f"{tag}: the route's kernels "
           f"{new} ran")
    _check_losses(got, want, 2e-3, f"{tag} small train step")

    cg, gg = _grads(cpu, cstate), _grads(gpu, gstate)
    cp, gp = _params(cpu), _params(gpu)
    for net in TRAINED:
        rel = _rel_l2(gg[net], cg[net])
        _check(rel <= 2e-2, f"{tag} small train step, {net} gradient "
               f"({len(cg[net])} tensors) on the card vs the CPU: relative "
               f"L2 {rel:.3g} <= 2e-2")
        upd = _rel_l2(gp[net], cp[net], p0[net])
        _check(upd <= 0.1, f"{tag} small train step, {net} update p1 - p0: "
               f"relative L2 {upd:.3g} <= 0.1")
    for net in ("gen", "corr"):
        pre = net + "."
        ce = {k: v.cpu().double() for k, v in cstate.ema.items()
              if k.startswith(pre)}
        ge = {k: gstate.ema[k].cpu().double() for k in ce}
        base = {k: p0[net][k[len(pre):]] for k in ce}
        ema = _rel_l2(ge, ce, base)
        _check(ema <= 0.1, f"{tag} small train step, {net} EMA shadow move: "
               f"relative L2 {ema:.3g} <= 0.1")

    worst, count = 0.0, 0
    for a, b in zip(cpu.modules(), gpu.modules()):
        sb = b.state_dict()
        for k, t in a.state_dict().items():
            if k.endswith(("weight_u", "weight_v")):
                worst = max(worst, _maxerr(sb[k].cpu(), t))
                count += 1
    _check(count > 0 and worst <= 2e-5,
           f"{tag} spectral u/v after the step ({count} vectors): max err "
           f"{worst:.3g} <= 2e-5")

    want, _ = cstep(cstate, batch, lr)
    got, _ = gstep(gstate, batch, lr)
    _check_losses(got, want, 2e-2, f"{tag} second small train step")


KERNEL_FAMILIES = (          # (family, substrings of the kernel name)
    ("conv3x3.cu", ("conv3x3_bf16_kernel", "conv3x3_f32_kernel")),
    ("conv operand copies", ("pad_channels", "k_major_weights")),
    ("conv3x3_onehot.cu", ("onehot::",)),
    ("shift9_fwd.cu", ("shift9_fwd::",)),
    ("shift9_bwd.cu", ("shift9_bwd_scores_kernel", "shift9_bwd_reduce_kernel",
                       "shift9_bwd::src")),
    ("corr_fwd.cu", ("corr_fwd_kernel",)),
    ("corr_bwd.cu", ("corr_bwd_scores_kernel", "corr_bwd::src")),
    ("conv3x3_dw.cu", ("conv3x3_dw_bf16_kernel", "conv3x3_dw_f32_kernel",
                       "reduce_splits")),
    ("library conv (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                              "implicit")),
    ("library matmul", ("gemm", "cutlass", "cublas")),
    ("optimizer (Adam, EMA)", ("multi_tensor", "adam")),
    ("softmax / reductions", ("softmax", "reduce", "norm")),
)


# (source, ((substring of the kernel name, part), ...)): the launches of
# the kernels that make more than one: the shift9 forward's two and the
# one-hot conv's two, the shift9 backward's five and the correlation
# backward's four (the GEMMs of tc_split.cuh, named after their source;
# dV's and dv's tiles: 96 columns where D > 32, as at the flagship, else
# 32, as in bench_corr)
KERNEL_PARTS = (
    ("shift9_fwd.cu", (("shift9_fwd::shift9_fwd_kernel",
                        "flash (S3, softmax, P V)"),
                       ("shift9_fwd::shift9_fwd_combine_kernel",
                        "combine of the key parts"))),
    ("conv3x3_onehot.cu", (("onehot::onehot_kernel", "gather"),
                           ("onehot::moments_kernel", "moments"))),
    ("shift9_bwd.cu", (("shift9_bwd_scores_kernel", "scores (P, dS3)"),
                       ("shift9_bwd_reduce_kernel", "side gradients"),
                       ("<shift9_bwd::Src, true, 4>", "dF3 = dS3 G3"),
                       ("<shift9_bwd::Src, false, 4>", "dG3 = dS3^T F3"),
                       ("<shift9_bwd::Src, false, 3>", "dV = P^T gO"),
                       ("<shift9_bwd::Src, false, 1>",
                        "dV = P^T gO (32-column tiles)"))),
    ("corr_bwd.cu", (("corr_bwd_scores_kernel", "scores (P, dS)"),
                     ("<corr_bwd::Src, true, 4>", "dq = dS k"),
                     ("<corr_bwd::Src, false, 4>", "dk = dS^T q"),
                     ("<corr_bwd::Src, false, 3>", "dv = P^T gO"),
                     ("<corr_bwd::Src, false, 1>",
                      "dv = P^T gO (32-column tiles)"))))


def profile_call(fn) -> None:
    """Device time of one call of `fn` by kernel family, from
    torch.profiler's CUDA kernel events, and the device's idle share of the
    host-timed call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: not measured (the profiler saw no device kernels)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s, e in spans:                    # union of the kernel intervals
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    fam = {}
    for e in kernels:
        name = e.name.lower()
        key = next((f for f, subs in KERNEL_FAMILIES
                    if any(s in name for s in subs)), "elementwise / other")
        n, us = fam.get(key, (0, 0.0))
        fam[key] = (n + 1, us + e.time_range.elapsed_us())
    total = sum(us for _, us in fam.values())
    print(f"profile: {len(kernels)} kernels, device busy {busy / 1e3:.2f} "
          f"ms of {wall_us / 1e3:.2f} ms host time (idle share "
          f"{1 - busy / wall_us:.3f}); kernel time by family:")
    for key, (n, us) in sorted(fam.items(), key=lambda kv: -kv[1][1]):
        print(f"  {key:24s} {n:5d} launches {us / 1e3:9.3f} ms "
              f"{us / total:6.1%}")
    # the kernels' parts, by kernel name and template arguments
    for src, parts in KERNEL_PARTS:
        for key, what in parts:
            us = sum(e.time_range.elapsed_us() for e in kernels
                     if key in e.name)
            if us:
                print(f"    {src} {what}: {us / 1e3:.3f} ms")


def inference_opt(cfg, match_kernel):
    """The flagship inference configuration (bench.py:31-37) at batch 6."""
    return cfg.test_defaults(
        dataset_mode="ade20k", label_nc=150, contain_dontcare_label=True,
        crop_size=256, load_size=256, batchSize=6, ngf=64,
        use_attention=True, maskmix=True, PONO=True, PONO_C=True,
        warp_mask_losstype="direct", match_kernel=match_kernel,
        isTrain=False)


def forward_conv_table(P, cfg, L, C, g) -> None:
    """Every conv3x3.cu shape of one flagship mk3 B6 forward (bf16 policy,
    full width), captured by tools/ab_dw.record_convs and routed by the
    gates as nn.layers.conv2d routes them: per (B, H, W, Cin, Cout, ring,
    statistics) the kernel against its plain version (phase 2's bf16
    tolerances), its count per forward, its time, F.pad + F.conv2d's on the
    same operands and the bound, then the totals over the forward (count x
    time), so that the forward's conv3x3.cu time reads shape by shape."""
    import collections
    from cocosnet_tpu_torch.tools import ab_dw as AB
    F = torch.nn.functional
    L.set_compute_dtype(torch.bfloat16)
    opt = inference_opt(cfg, 3)
    nets = P.Pix2PixNets(opt, seed=0)
    condition_weights(nets.corr, g, "cuda")
    condition_weights(nets.gen, g, "cuda")
    data = P.preprocess_input(opt, make_batch(g, 6, 256, 256,
                                              opt.semantic_nc))
    records = AB.record_convs(lambda: P.inference(nets, data))
    L.set_compute_dtype(None)
    del nets, data
    torch.cuda.empty_cache()
    shapes = collections.Counter()
    for r in records:
        xs, ks = r["x_shape"], r["kernel_shape"]
        gate = dict(stride=r["stride"],
                    padding=1 if r["reflect"] else r["padding"])
        if r["onehot"]:
            continue
        stats = bool(r["want_stats"]
                     and L.conv3x3_stats_supported(xs, ks, **gate))
        if stats or (not r["want_stats"]
                     and L.conv3x3_supported(xs, ks, **gate)):
            shapes[tuple(xs) + (ks[3], r["reflect"], stats)] += 1
    print("conv3x3.cu shapes of one mk3 B6 forward (bf16; ms per call; "
          "cuDNN = F.pad + F.conv2d):", flush=True)
    print(f"     {'B,H,W,Cin->Cout,ring,stats':>32s} {'count':>5s} "
          f"{'kernel':>8s} {'cuDNN':>8s} {'bound':>8s} {'TFLOP/s':>8s}",
          flush=True)
    tot = collections.Counter()
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
        flops = 2.0 * b * h * w * 9 * ci * co
        bms, _ = bound_ms(_nbytes(x, k, bias) + b * h * w * co * 2, flops,
                          BF16_FLOP_S)
        tot.update(kernel=n * ms, cudnn=n * lib_ms, bound=n * bms,
                   launches=n)
        print(f"     {label:>32s} {n:>5d} {ms:>8.3f} {lib_ms:>8.3f} "
              f"{bms:>8.3f} {flops / ms / 1e9:>8.1f}", flush=True)
        del x, k, bias, xc, wc, bc
    torch.cuda.empty_cache()
    _check(tot["launches"] == CONVS["conv3x3_fused"]
           + CONVS["conv3x3_fused_stats"],
           f"the table covers the forward's {int(tot['launches'])} "
           f"conv3x3.cu launches")
    print(f"     totals over the forward: kernel {tot['kernel']:.2f} ms, "
          f"cuDNN {tot['cudnn']:.2f} ms, bound {tot['bound']:.2f} ms",
          flush=True)


def flagship_inference(P, cfg, L, g, match_kernel, timed_runs) -> dict:
    """Phases 4 and 4b: flagship-width inference (batch 6 and batch 1, bf16
    policy, seeded random weights) at `match_kernel`: the launches of one
    forward, the outputs' shapes and ranges, images/s, batch-1 latency,
    peak memory (the phase's own) and profiles. Returns the launches."""
    L.set_compute_dtype(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    opt = inference_opt(cfg, match_kernel)
    nets = P.Pix2PixNets(opt, seed=0)
    condition_weights(nets.corr, g, "cuda")
    condition_weights(nets.gen, g, "cuda")
    batch = make_batch(g, 6, 256, 256, opt.semantic_nc)
    counted = _counted()
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
    profile_call(lambda: P.inference(nets, data))
    profile_call(lambda: P.inference(nets, data1))
    del nets, out, data, data1
    torch.cuda.empty_cache()
    return launches


def flagship_training(P, cfg, TS, ST, g, match_kernel, route, steps) -> dict:
    """Phases 5, 5b, 5c and 5d: flagship-width training at batch 8 under the
    bf16 policy through make_train_step, at `match_kernel` on `route` (the
    correlation's at match_kernel 1; "kernels", "dw" or "fused" at 3): the
    launches of one step, against TRAIN_LAUNCHES and against the routing's
    prediction from the step's recorded convs, finite losses, two warm-up
    steps, then `steps` timed steps, peak memory and a profile of one step.
    Returns the launches of the counted step."""
    from cocosnet_tpu_torch.tools import ab_dw as AB
    opt = train_opt(cfg, label_nc=150, crop_size=256, load_size=256,
                    batchSize=8, ngf=64, ndf=64, match_kernel=match_kernel)
    tag = f"match_kernel {match_kernel} flagship training ({route} route)"
    nets = P.Pix2PixNets(opt, seed=0)
    for net in nets.modules():
        condition_weights(net, g, "cuda")
    state = TS.create_train_state(opt, nets)
    step = ST.make_train_step(nets)
    lr = TS.lrs_for_epoch(opt, 1)
    batch = {k: v.cuda() for k, v in
             make_batch(g, 8, 256, 256, opt.semantic_nc).items()}
    torch.cuda.reset_peak_memory_stats()

    def finite(losses):
        return all(bool(torch.isfinite(v)) for v in losses.values())

    counted = _counted()
    _zero_counts(counted)
    res = []
    records = AB.record_convs(lambda: res.append(step(state, batch, lr)))
    losses, vis = res[0]
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    print(f"launches in one {tag} step: {launches}", flush=True)
    expected = TRAIN_LAUNCHES[(match_kernel, route)]
    predicted = _launches(**_corr_launches(match_kernel, route),
                          **AB.predicted_launches(records))
    _check(launches == expected == predicted,
           f"every kernel of the train path launched as TRAIN_LAUNCHES "
           f"states {expected} and the routing predicts from the step's "
           f"{len(records)} convs")
    _check(len(losses) == 9 and finite(losses),
           "9 loss terms, all finite: " + ", ".join(
               f"{k} {float(v):.4g}" for k, v in sorted(losses.items())))
    _check(tuple(vis["fake_image"].shape) == (8, 256, 256, 3)
           and bool(torch.isfinite(vis["fake_image"]).all()),
           "fake_image (8, 256, 256, 3) finite")
    losses, _ = step(state, batch, lr)          # second warm-up
    _check(finite(losses), "second step's losses finite")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        losses, _ = step(state, batch, lr)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t) / steps
    _check(finite(losses), f"losses finite after {steps + 2} steps")
    print(f"{tag} batch 8: {dt:.4f} s/step, {8 / dt:.2f} images/s ({steps} "
          f"steps after 2 warm-ups, host clock); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_call(lambda: step(state, batch, lr))
    del nets, state, step, batch, losses, vis
    torch.cuda.empty_cache()
    return launches


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t_start = t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: each kernel against its plain version at flagship shapes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    rows = {}
    for pono_c in (True, False):
        r = check_shift9(S, g, pono_c=pono_c)
        rows.setdefault("attend_shift9", r)
    # the backward at the flagship training shape (batch 8), then an image
    # width of 128 (a 512 px crop), forward and backward
    for pono_c in (True, False):
        r = check_shift9_bwd(S, g, b=8, h=64, w=64, c=256, d=154,
                             pono_c=pono_c, timed=True)
        rows.setdefault("attend_shift9_backward", r)
    check_shift9_bwd(S, g, b=1, h=128, w=128, c=256, d=154, pono_c=True,
                     timed=False)
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

    # phase 3: the small-input slices against the plain versions
    for mk in (3, 1):
        reference_check(P, cfg, g, mk)
    # phase 3b: small f32 train steps against the plain versions
    for mk, route in ((3, "kernels"), (1, "library"), (1, "kernels"),
                      (3, "dw all"), (3, "fused")):
        with train_route(route):
            train_reference_check(P, cfg, L, TS, ST, g, mk, route)
        torch.cuda.empty_cache()

    # phases 4 and 4b: flagship-width inference, bf16 policy
    runs = {"inference": flagship_inference(P, cfg, L, g, 3, 10),
            "match_kernel 1 inference": flagship_inference(P, cfg, L, g, 1,
                                                           10)}
    # phases 5 and 5b: flagship-width training, bf16 policy
    runs["train step"] = flagship_training(P, cfg, TS, ST, g, 3, "kernels",
                                           10)
    for route in ("library", "kernels"):
        with train_route(route):
            runs[f"match_kernel 1 train step, {route} route"] = \
                flagship_training(P, cfg, TS, ST, g, 1, route, 10)
    # phases 5c and 5d: the flagship train step on its two conv routes
    for route, path in (("dw", "train step, COCOSNET_PALLAS_DW=1"),
                        ("fused", "train step, COCOSNET_FUSED_CONV_TRAIN=1")):
        with train_route(route):
            runs[path] = flagship_training(P, cfg, TS, ST, g, 3, route, 5)
    L.set_compute_dtype(None)

    # phase 6: the tool twins at their defaults; bench_corr is the path of
    # the large-descriptor kernels
    from cocosnet_tpu_torch.tools import ab_dw, bench_corr
    print("tools/ab_dw.py twin:", flush=True)
    ab_dw.main([])
    counted = _counted()
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
    kernels = [dict(name=k, route="cuda", source=source, replaces=replaces,
                    path=path, launches=runs[path][k], **rows[k])
               for k, (source, replaces, path) in src.items()]
    print(f"chip_smoke.py ran in {time.perf_counter() - t_start:.0f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
