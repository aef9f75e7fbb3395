"""The comparison that decides `correct`: what the timed path produced
against the plain reference, each number beside its limit.

Served images (the uint8 levels a request got back): `image_mad`, the
worst sampled image's mean absolute level difference from the reference's
levels.

Training (the first three steps of the run, through the window's own call:
two eager warm-up steps, then the captured graph's first replay):
- from the start, the reference following from the same seeded weights on
  the same batches: `loss_gap`, the worst loss term of the first step, as
  the gap between the program's and the reference's value over the larger
  of the reference's |value| and the step's median |term|; `change_gap`,
  the median trained leaf after three steps, as the gap between the norms
  of the two sides' change from the start, over the larger of the
  reference's change and the median leaf's; `ema_gap`, the same over the
  EMA shadows alone, against their own median (a shadow moves about a
  thousandth as far as its leaf);
- the first replayed step, the reference taking its step from the
  program's own state before it (weights, buffers, Adam's moments and
  counts, EMA shadows; by the third step the two runs have parted, as the
  first Adam steps at beta1 0 move each leaf by about +-lr, whose sign a
  gradient at rounding level decides): `replay_loss_gap`, its worst term
  as `loss_gap`; `replay_change_gap`, its change of the median leaf as
  `change_gap`.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out (FLOOR: they move under Adam by round-off alone).

The control computes the reference with every convolution's operands and
output rounded to fp8 (e4m3, one scale per tensor; the configurations' bf16
policy keeps them in bf16): `fp8_round`.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List

import torch

FLOOR = 1e-3          # the share of the median leaf's gradient kept


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale (amax to 448), with
    the gradient passed straight through."""
    d = x.detach()
    scale = 448.0 / d.abs().amax().float().clamp_min(1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).to(d.dtype) / scale
    return x + (q - d)


def image_mad(got: List[torch.Tensor], want: List[torch.Tensor]) -> float:
    """Worst image's mean |level difference| over lists of (B, H, W, 3)
    uint8 batches."""
    worst = 0.0
    for g, w in zip(got, want):
        diff = (g.int() - w.int().to(g.device)).abs().float()
        worst = max(worst, float(diff.mean(dim=(1, 2, 3)).max()))
    return worst


def _gap(a: float, b: float, base: float) -> float:
    return abs(a - b) / base if base > 0 else (0.0 if a == b else
                                               float("inf"))


def loss_gaps(got: Dict[str, float],
              want: Dict[str, float]) -> Dict[str, float]:
    """{term: gap} of one step's loss terms."""
    if set(got) != set(want):
        return {"terms": float("inf")}
    med = statistics.median(abs(v) for v in want.values())
    return {k: _gap(got[k], v, max(abs(v), med)) for k, v in want.items()}


def norm_gaps(got: Dict[str, float],
              want: Dict[str, float]) -> Dict[str, float]:
    """{leaf: |got - want| over max(want, the median want)}."""
    if set(got) != set(want):
        return {"leaves": float("inf")}
    med = statistics.median(want.values())
    return {k: _gap(got[k], w, max(w, med)) for k, w in want.items()}


def kept_leaves(ref_grads: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least FLOOR times the
    median leaf's."""
    med = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= FLOOR * med]


def leaf_of(name: str) -> str:
    """The trained leaf an EMA shadow ("ema." + the leaf's name) follows."""
    return name[4:] if name.startswith("ema.") else name


def change_norms(leaves: Dict[str, torch.Tensor],
                 start: Dict[str, torch.Tensor], kept) -> Dict[str, float]:
    """{leaf: ||leaf - its start||} of the trained leaves and EMA shadows
    whose leaf is in `kept`."""
    out = {}
    for k, v in leaves.items():
        if leaf_of(k) in kept:
            p0 = start[leaf_of(k)]
            out[k] = float((v.detach().to(p0.device) - p0).norm())
    return out


def split(d: Dict[str, float]):
    """(trained leaves, EMA shadows) of a {name: value}."""
    return ({k: v for k, v in d.items() if not k.startswith("ema.")},
            {k: v for k, v in d.items() if k.startswith("ema.")})


def median_gap(got, want) -> float:
    return statistics.median(norm_gaps(got, want).values())


def train_readings(losses, want_losses, after, want_after, start,
                   want_grads) -> Dict[str, float]:
    """The numbers of the run from its start: the first step's losses,
    and the leaves and EMA shadows after three steps, the reference's
    first gradient norms deciding which leaves count."""
    kept = set(kept_leaves(want_grads))
    leaves, ema = split(change_norms(after, start, kept))
    want_leaves, want_ema = split(change_norms(want_after, start, kept))
    out = {"loss_gap": max(loss_gaps(losses, want_losses).values()),
           "change_gap": median_gap(leaves, want_leaves)}
    if want_ema:
        out["ema_gap"] = median_gap(ema, want_ema) if ema else float("inf")
    return out


def replay_readings(losses, want_losses, after, want_after, mid,
                    want_grads) -> Dict[str, float]:
    """The numbers of the first replayed step against the reference's
    step from the same state (`mid`, the weights before it): its losses
    and its change of the trained leaves, the reference's gradient norms
    of the step deciding which leaves count."""
    kept = set(kept_leaves(want_grads))
    leaves = change_norms(split(after)[0], mid, kept)
    want_leaves = change_norms(split(want_after)[0], mid, kept)
    return {"replay_loss_gap": max(loss_gaps(losses,
                                             want_losses).values()),
            "replay_change_gap": median_gap(leaves, want_leaves)}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Prints each number beside its limit to standard error, last; True
    when every number is within its limit."""
    ok = True
    for k, v in readings.items():
        lim = limits[k]
        fine = v <= lim
        ok &= fine
        mark = "" if fine else " FAILED"
        print(f"compared {k}: {v!r} (limit {lim!r}){mark}",
              file=sys.stderr, flush=True)
    return ok
