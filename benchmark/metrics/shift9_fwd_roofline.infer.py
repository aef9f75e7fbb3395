"""% of its roofline: csrc/shift9_fwd.cu's calls of a forward."""

from benchmark import readers


def read(run):
    return readers.roofline(run, "shift9_fwd.cu")
