#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for the
H100): builds the hand-written kernels, holds each against its plain
PyTorch version at the flagship shapes, then runs flagship ADE20k inference
(256 px, batch 6, ngf 64, 151 classes, bf16 policy, seeded random weights)
through preprocess_input and inference, and checks that every kernel of
that path was launched.

    python3 chip_smoke.py

Prints the card's name and power limit, one line per check, a `kernels`
JSON line (per kernel: launches in one flagship forward, max error against
its plain version, its time, the plain version's, the library call's and
the least time the card could take), the device time of one batch-6 and
one batch-1 forward by kernel family (torch.profiler) with the device's
idle share, and as its last line
{"ok": true, "device": {...}}. Exits non-zero, with no such line, if there
is no CUDA device, a kernel does not build or disagrees, or an output is
wrong. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

# published peaks of one H100 SXM (dense): bytes/s of HBM3, f32 FLOP/s
# outside the tensor cores, bf16 FLOP/s on the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
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
    kd = k.to(dtype)
    ms = time_ms(lambda: C._onehot_kernel(lab, kd, bias, dtype, None, True))
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
    print(f"     onehot {dtype}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, F.conv2d(dense one-hot) {library_ms:.3f} ms, bound "
          f"{bms:.3f} ms ({by})", flush=True)
    return dict(max_abs_err=errs[0], ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


def check_shift9(S, g, *, pono_c):
    dev = "cuda"
    b, h, w, c, d = 6, 64, 64, 256, 154
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
    plain_ms = time_ms(lambda: S.shift9_core_plain(f3, g3, v, qv, kv, w),
                       runs=5)
    wrapper_ms = time_ms(lambda: S.attend_shift9(f, gg, v, 0.01, pono_c))
    torch.cuda.empty_cache()
    n = h * w
    flops = 2.0 * b * n * n * (3 * c + d)
    nb = _nbytes(f3, g3, v, qv, kv) + b * n * (d + 1) * 4
    bms, by = bound_ms(nb, flops, F32_FLOP_S)
    print(f"     shift9 pono_c={pono_c}: kernel {ms:.3f} ms (with the "
          f"torch prep {wrapper_ms:.3f} ms), plain {plain_ms:.3f} ms, bound "
          f"{bms:.3f} ms ({by}, {flops / 1e9:.1f} GFLOP)", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


# ------------------------------------------------------------------ phase 3

def _counted():
    """The kernel entries of the flagship path, by name."""
    from cocosnet_tpu_torch.ops import conv3x3 as C
    from cocosnet_tpu_torch.ops import shift9 as S
    return {"attend_shift9": S.attend_shift9,
            "conv3x3_fused": C.conv3x3_fused,
            "conv3x3_fused_stats": C.conv3x3_fused_stats,
            "conv3x3_onehot": C.conv3x3_onehot}


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


def reference_check(P, cfg, g):
    """The whole slice on the card (kernels, f32) against the same weights
    and batch through the plain versions on the CPU, at a small input
    (128 x 256, ngf 16, 13 classes: a 32 x 64 feature map) that takes
    every kernel; atol 5e-4 as the CPU parity tests hold the slice against
    the JAX package."""
    opt = cfg.test_defaults(
        dataset_mode="ade20k", label_nc=12, contain_dontcare_label=True,
        crop_size=256, load_size=256, aspect_ratio=2.0, batchSize=1, ngf=16,
        use_attention=True, maskmix=True, PONO=True, PONO_C=True,
        warp_mask_losstype="direct", isTrain=False)
    batch = make_batch(g, 1, 128, 256, opt.semantic_nc)
    cpu = P.Pix2PixNets(opt, device="cpu", seed=1)
    condition_weights(cpu.corr, g, "cpu")
    condition_weights(cpu.gen, g, "cpu")
    gpu = P.Pix2PixNets(opt, device="cuda", seed=1)
    gpu.corr.load_state_dict(cpu.corr.state_dict())
    gpu.gen.load_state_dict(cpu.gen.state_dict())
    want = P.inference(cpu, P.preprocess_input(opt, batch, device="cpu"))
    counted = _counted()
    before = {k: fn.launches for k, fn in counted.items()}
    got = P.inference(gpu, P.preprocess_input(opt, batch, device="cuda"))
    moved = {k: fn.launches - before[k] for k, fn in counted.items()}
    _check(all(moved.values()), f"small input launched every kernel {moved}")
    for key in ("fake_image", "warp_out", "warp_mask"):
        err = _maxerr(got[key].cpu(), want[key])
        _check(err <= 5e-4, f"small-input slice on the card vs plain on the "
               f"CPU, {key}: max err {err:.3g} <= 5e-4")


KERNEL_FAMILIES = (          # (family, substrings of the kernel name)
    ("conv3x3.cu", ("conv3x3_kernel",)),
    ("conv3x3_onehot.cu", ("onehot_kernel",)),
    ("shift9_fwd.cu", ("shift9_fwd_kernel",)),
    ("library conv (cuDNN)", ("conv", "fprop", "cudnn", "implicit")),
    ("library matmul", ("gemm", "cutlass", "cublas")),
    ("softmax / reductions", ("softmax", "reduce", "norm")),
)


def profile_forward(fn) -> None:
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


def main() -> None:
    if not torch.cuda.is_available():
        _fail("no CUDA device: this smoke test runs only on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cocosnet_tpu_torch import config as cfg
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.nn import layers as L
    from cocosnet_tpu_torch.ops import _build
    from cocosnet_tpu_torch.ops import conv3x3 as C
    from cocosnet_tpu_torch.ops import shift9 as S

    # phase 1: environment and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
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
    torch.cuda.empty_cache()

    # phase 3: the small-input slice against the plain versions
    reference_check(P, cfg, g)

    # phase 4: flagship inference, bf16 policy, seeded random weights
    L.set_compute_dtype(torch.bfloat16)
    opt = cfg.test_defaults(
        dataset_mode="ade20k", label_nc=150, contain_dontcare_label=True,
        crop_size=256, load_size=256, batchSize=6, ngf=64,
        use_attention=True, maskmix=True, PONO=True, PONO_C=True,
        warp_mask_losstype="direct", match_kernel=3, isTrain=False)
    nets = P.Pix2PixNets(opt, seed=0)
    condition_weights(nets.corr, g, "cuda")
    condition_weights(nets.gen, g, "cuda")
    batch = make_batch(g, 6, 256, 256, opt.semantic_nc)
    counted = _counted()
    for fn in counted.values():
        fn.launches = 0
    out = P.inference(nets, P.preprocess_input(opt, batch))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    print(f"launches in one flagship forward: {launches}", flush=True)
    expected = {"attend_shift9": 1, "conv3x3_fused": 80,
                "conv3x3_fused_stats": 20, "conv3x3_onehot": 1}
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
    fwd_ms = time_ms(lambda: P.inference(nets, data), runs=10)
    one = {k: v[:1] for k, v in batch.items()}
    data1 = P.preprocess_input(opt, one)
    lat = []
    for _ in range(12):
        t = time.perf_counter()
        P.inference(nets, P.preprocess_input(opt, one))
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t))
    lat = sorted(lat[2:])
    fwd1_ms = time_ms(lambda: P.inference(nets, data1), runs=10)
    print(f"flagship batch 6: {fwd_ms:.2f} ms per forward, "
          f"{6e3 / fwd_ms:.2f} images/s; batch 1: p50 "
          f"{lat[len(lat) // 2]:.2f} ms end to end with preprocessing "
          f"({fwd1_ms:.2f} ms forward); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_forward(lambda: P.inference(nets, data))
    profile_forward(lambda: P.inference(nets, data1))

    src = {"attend_shift9": ("cocosnet_tpu_torch/csrc/shift9_fwd.cu",
                             "cocosnet_tpu/ops/pallas_shift9.py:173"),
           "conv3x3_fused": ("cocosnet_tpu_torch/csrc/conv3x3.cu",
                             "cocosnet_tpu/ops/pallas_conv.py:174"),
           "conv3x3_fused_stats": ("cocosnet_tpu_torch/csrc/conv3x3.cu",
                                   "cocosnet_tpu/ops/pallas_conv.py:174"),
           "conv3x3_onehot": ("cocosnet_tpu_torch/csrc/conv3x3_onehot.cu",
                              "cocosnet_tpu/ops/pallas_conv.py:808")}
    kernels = [dict(name=k, route="cuda", source=src[k][0],
                    replaces=src[k][1], launches=launches[k], **rows[k])
               for k in expected]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
