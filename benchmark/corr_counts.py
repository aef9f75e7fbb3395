"""The yardstick of the dense correlation forward (csrc/corr_fwd.cu, the
match_kernel 1 route): the work of one call counted from the cell's
configuration and traffic, so that it is the same whatever implements the
kernel, and its share of the roofline from the traced segment.

One call attends the label map's (crop / 4)^2 positions over the
exemplar's as many, on C = 256 k^2 channels of centred, L2-normalized
descriptors, and warps D values: the exemplar's pooled colours (3, or 48
for its 4 x 4 patches) and, under the direct mask loss, its label map
(semantic_nc). The formula is the port's utils/profiling.corr_fwd_flops,
copied for the reason benchmark/counts.py gives.
"""

from __future__ import annotations

from typing import Optional, Tuple

from benchmark import counts

FAMILY = "corr_fwd.cu"
MARKERS = ("corr_fwd_kernel",)      # one launch a call
F32 = 4


def corr_fwd_flops(b, n, m, c, d) -> float:
    """The dense correlation forward: S = q k^T over C and P v over D,
    2 B N M (C + D)."""
    return 2.0 * b * n * m * (c + d)


def shapes(model: dict, batch: int) -> Tuple[int, int, int, int, int]:
    """(B, N, M, C, D) of one call at the configuration's sizes."""
    n = (model["crop_size"] // 4) ** 2
    c = 256 * model["match_kernel"] ** 2
    d = 48 if model["warp_patch"] else 3
    if model["warp_mask_losstype"] == "direct":
        d += model["semantic_nc"]
    return batch, n, n, c, d


def call(model: dict, batch: int) -> Tuple[float, float]:
    """(operations, bytes) of one call: q, k, v and o in float32, each
    read or written once, and the row log-sum-exp."""
    b, n, m, c, d = shapes(model, batch)
    nbytes = F32 * (b * n * c + b * m * c + b * m * d + b * n * d + b * n)
    return corr_fwd_flops(b, n, m, c, d), float(nbytes)


def roofline(run) -> Optional[float]:
    """% of the least time of the traced calls (each call's operations at
    the bf16 peak or its bytes at the HBM rate, whichever is longer) over
    the family's device time; a call is a record of the once-a-call
    kernel, so a record the profiler lost counts neither way."""
    if run.trace is None or not run.trace.kernels:
        return None
    records = run.trace.records(MARKERS)
    spent = run.trace.family_s().get(FAMILY, 0.0)
    if not records or spent <= 0:
        return None
    ops, nbytes = call(run.config["model"], run.traffic["batch"])
    return 100.0 * counts.bound_s(ops, nbytes)[0] * records / spent
