"""% of its roofline: csrc/conv3x3.cu's calls of a forward, with the operand
copies its wrapper launches."""

from benchmark import readers


def read(run):
    return readers.roofline(run, "conv3x3.cu", "conv operand copies")
