"""% of its roofline: csrc/shift9_bwd.cu's calls of a train step."""

from benchmark import readers


def read(run):
    return readers.roofline(run, "shift9_bwd.cu")
