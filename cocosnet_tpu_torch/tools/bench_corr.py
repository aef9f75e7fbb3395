"""A/B of the correlation paths, with an accuracy audit, on one GPU. Twin of
tools/bench_corr.py, at its flagship shape (256 px, down 4 -> N = M = 4096;
match_kernel 3 -> 2304-dim descriptors, PONO_C centered):

  - attend_chunked     the library route over the 2304-dim descriptors
                       (ops/correlation)
  - attend_corr_bigc   the flash kernels for large descriptors
                       (ops/corr_bigc: corr_fwd.cu, corr_bwd.cu)
  - attend_unfold      the 9-shift decomposition (ops/corr_shift)
  - attend_shift9      the fused shift9 kernels (ops/shift9)

For each, the forward and the forward + backward (of sum(out^2) with respect
to all three inputs) in ms by CUDA events, and the max error against an f32
dense oracle on the first batch element (TF32 off). Prints a markdown table.
From the repository root:

    python -m cocosnet_tpu_torch.tools.bench_corr [--batch 6] [--iters 20]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cocosnet_tpu_torch.tools import time_ms

TAU = 0.01


def descriptor(y: torch.Tensor, pono_c: bool = True) -> torch.Tensor:
    """Centered, L2-normalized 3x3-unfold descriptors (B, H*W, 9C) of the
    features y (B, H, W, C), as the JAX tool builds them."""
    from cocosnet_tpu_torch.ops.image import unfold_descriptors
    desc = unfold_descriptors(y.float(), 3)
    desc = desc - desc.mean(dim=-1 if pono_c else 1, keepdim=True)
    norm = torch.sqrt((desc * desc).sum(-1, keepdim=True) + 1e-24)
    return desc / (norm + sys.float_info.epsilon)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--hw", type=int, default=64)
    ap.add_argument("--c", type=int, default=256)
    ap.add_argument("--d", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--pono_c", action=argparse.BooleanOptionalAction,
                    default=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_corr times kernels on a CUDA device; none "
                         "found")
    from cocosnet_tpu_torch.ops.corr_bigc import attend_corr_bigc
    from cocosnet_tpu_torch.ops.corr_shift import attend_unfold
    from cocosnet_tpu_torch.ops.correlation import attend_chunked
    from cocosnet_tpu_torch.ops.shift9 import attend_shift9

    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, c, d = args.batch, args.hw, args.c, args.d
    n = h * h
    rs = np.random.RandomState(0)
    # conv outputs are zero-mean-ish and unit-scale
    f = torch.from_numpy(rs.randn(b, h, h, c).astype(np.float32)).cuda()
    g = torch.from_numpy(rs.randn(b, h, h, c).astype(np.float32)).cuda()
    v = torch.from_numpy(rs.randn(b, n, d).astype(np.float32)).cuda()
    q, k = descriptor(f, args.pono_c), descriptor(g, args.pono_c)
    oracle = torch.softmax(q[:1] @ k[:1].transpose(1, 2) / TAU, -1) @ v[:1]

    paths = [
        ("attend_chunked (C=2304)",
         lambda a, b_, v_: attend_chunked(a, b_, v_, TAU), (q, k, v)),
        ("attend_corr_bigc (C=2304)",
         lambda a, b_, v_: attend_corr_bigc(a, b_, v_, TAU), (q, k, v)),
        ("attend_unfold (9-shift)",
         lambda a, b_, v_: attend_unfold(a, b_, v_, TAU, 3, args.pono_c,
                                         row_chunk=4), (f, g, v)),
        ("attend_shift9 (fused)",
         lambda a, b_, v_: attend_shift9(a, b_, v_, TAU, args.pono_c),
         (f, g, v)),
    ]
    rows = []
    for name, fn, inputs in paths:
        with torch.no_grad():
            err = float((fn(*inputs)[:1] - oracle).abs().max())
            fwd = time_ms(lambda: fn(*inputs), args.iters)
        leaves = [t.detach().clone().requires_grad_() for t in inputs]

        def fwd_bwd():
            torch.autograd.grad((fn(*leaves) ** 2).sum(), leaves)

        both = time_ms(fwd_bwd, args.iters)
        torch.cuda.empty_cache()
        rows.append(dict(path=name, fwd_ms=fwd, fwd_bwd_ms=both, err=err))
        print(f"{name:28s} fwd {fwd:8.3f} ms   fwd+bwd {both:8.3f} ms   "
              f"max|err| {err:.2e}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = flags

    print("\n| path | fwd ms | fwd+bwd ms | max err vs f32 oracle |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['path']} | {r['fwd_ms']:.3f} | {r['fwd_bwd_ms']:.3f} | "
              f"{r['err']:.2e} |", flush=True)
    return rows


if __name__ == "__main__":
    main()
