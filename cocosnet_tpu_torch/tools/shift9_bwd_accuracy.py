"""Accuracy of the shift9 backward kernel (csrc/shift9_bwd.cu) on one GPU,
over random draws at the small shapes of tests/test_torch_cuda.py: each of
the five outputs' largest error relative to its largest magnitude, for the
kernel against the plain version in f32 (what the card tests and
chip_smoke.py compare, at 1e-4), the kernel against the plain version in
f64 on the same f32 inputs, and the f32 plain version against the f64 one.
The f64 evaluation says which side of a kernel-vs-plain difference is off.

    python -m cocosnet_tpu_torch.tools.shift9_bwd_accuracy [--draws 4]

Prints one line per comparison: the worst error of each output and the
draws over 1e-4.
"""

from __future__ import annotations

import argparse
import sys

import torch

NAMES = ("dF3", "dqv", "dG3", "dkv", "dV")
# (H, W, C, D): tests/test_torch_cuda.py's shapes for the backward kernel
SHAPES = [(8, 16, 16, 3), (16, 16, 8, 5), (4, 128, 16, 7), (2, 128, 32, 40),
          (5, 13, 8, 4), (4, 16, 16, 154), (20, 13, 8, 5)]


def _rel(got, want):
    return [float((a.double() - b.double()).abs().max()
                  / b.double().abs().max()) for a, b in zip(got, want)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=4,
                    help="draws per shape and centering")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("shift9_bwd_accuracy: no CUDA device")
    from cocosnet_tpu_torch.ops import shift9 as S
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    rows = {"kernel vs plain f32": [], "kernel vs plain f64": [],
            "plain f32 vs plain f64": []}
    for _ in range(args.draws):
        for h, w, c, d in SHAPES:
            for pono_c in (True, False):
                f = torch.randn(2, h, w, c, generator=g).cuda()
                gg = (torch.randn(2, h, w, c, generator=g) * 1.5 + 0.2).cuda()
                v = torch.randn(2, h * w, d, generator=g).cuda()
                go = torch.randn(2, h * w, d, generator=g).cuda()
                f3, g3, qv, kv = S.shift9_inputs(f, gg, 0.01, pono_c)
                o, lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
                args_ = (f3, g3, v, qv, kv, lse, go, (go * o).sum(-1), w)
                got = S.shift9_bwd_kernel(*args_)
                plain = S.shift9_bwd_plain(*args_)
                exact = S.shift9_bwd_plain(*(
                    a.double() if torch.is_tensor(a) else a for a in args_))
                key = ((h, w, c, d), pono_c)
                rows["kernel vs plain f32"].append((key, _rel(got, plain)))
                rows["kernel vs plain f64"].append((key, _rel(got, exact)))
                rows["plain f32 vs plain f64"].append((key, _rel(plain,
                                                                 exact)))
    smi = torch.cuda.get_device_name(0)
    print(f"shift9 backward accuracy on {smi}, {args.draws} draws per shape "
          f"and centering:", flush=True)
    out = {}
    for name, rs in rows.items():
        worst = [max(r[1][i] for r in rs) for i in range(5)]
        over = sum(max(r[1]) > 1e-4 for r in rs)
        out[name] = dict(worst=dict(zip(NAMES, worst)), over=over,
                         draws=len(rs))
        print(f"  {name}: worst " + ", ".join(
            f"{n} {x:.3g}" for n, x in zip(NAMES, worst))
            + f"; {over} of {len(rs)} draws over 1e-4", flush=True)
    return out


if __name__ == "__main__":
    main()
