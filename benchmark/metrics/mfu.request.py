"""% of the bf16 dense peak in model FLOPs over the window."""

from benchmark import readers


def read(run):
    return readers.mfu(run)
