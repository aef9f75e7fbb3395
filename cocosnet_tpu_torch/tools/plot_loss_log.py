"""Plot training curves from a loss_log.txt (the reference's log format,
util/util.py:320-331, which the port's utils/logging.print_current_errors
writes: `(epoch: E, iters: I, time: T) name: val name: val ...`). Twin of
tools/plot_loss_log.py; matplotlib is imported only under --out. The work
is on the host; --platform is the port's entry-point flag, as on the other
twins (the card by default, raising without one; cpu).

    python -m cocosnet_tpu_torch.tools.plot_loss_log \\
        checkpoints/<name>/loss_log.txt [--out curves.png] \\
        [--json curves.json] [--smooth 9] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np

_HEAD = re.compile(r"\(epoch:\s*(\d+),\s*iters:\s*(\d+),\s*time:\s*([-\d.]+)\)")
_TERM = re.compile(r"([A-Za-z_/][\w/]*):\s*(nan|inf|-inf|[-\d.e+]+)")


def parse(path: str):
    steps, curves = [], {}
    with open(path) as f:
        for line in f:
            head = _HEAD.search(line)
            if not head:
                continue
            terms = _TERM.findall(line[head.end():])
            if not terms:
                continue
            steps.append((int(head.group(1)), int(head.group(2))))
            for name, val in terms:
                curves.setdefault(name, []).append(float(val))
    # global step index: (epoch, iters) pairs are monotone in file order
    return list(range(len(steps))), steps, curves


def main(argv=None) -> None:
    from cocosnet_tpu_torch.cli.common import device_for
    ap = argparse.ArgumentParser()
    ap.add_argument("log")
    ap.add_argument("--out", default="")
    ap.add_argument("--json", default="")
    ap.add_argument("--smooth", type=int, default=9)
    ap.add_argument("--platform", default="",
                    help="'' or gpu: the card (raises without one); cpu")
    args = ap.parse_args(argv)
    device_for(args.platform)

    idx, steps, curves = parse(args.log)
    if not idx:
        sys.exit(f"no loss lines parsed from {args.log}")
    print(f"{len(idx)} log points, epochs {steps[0][0]}..{steps[-1][0]}, "
          f"terms: {sorted(curves)}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"epoch_iters": steps, "curves": curves}, f)

    if args.out:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        names = [n for n in sorted(curves) if n != "img/s"]
        ncol = 3
        nrow = (len(names) + ncol - 1) // ncol
        fig, axes = plt.subplots(nrow, ncol, figsize=(4 * ncol, 2.6 * nrow),
                                 squeeze=False)
        k = max(1, args.smooth)
        for ax, name in zip(axes.flat, names):
            y = np.asarray(curves[name], np.float64)
            ax.plot(idx[:len(y)], y, lw=0.6, alpha=0.35)
            if len(y) > k:
                sm = np.convolve(y, np.ones(k) / k, mode="valid")
                ax.plot(idx[k - 1:k - 1 + len(sm)], sm, lw=1.5)
            ax.set_title(name, fontsize=9)
            ax.tick_params(labelsize=7)
        for ax in axes.flat[len(names):]:
            ax.axis("off")
        fig.suptitle(args.log, fontsize=8)
        fig.tight_layout()
        fig.savefig(args.out, dpi=110)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
