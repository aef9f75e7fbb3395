"""% of its roofline: csrc/corr_fwd.cu's calls of a forward (the
match_kernel 1 correlation), counted from the cell's shapes."""

from benchmark import corr_counts


def read(run):
    return corr_counts.roofline(run)
