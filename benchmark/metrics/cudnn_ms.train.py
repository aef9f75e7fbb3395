"""Device ms a train step in cuDNN's convolutions."""

from benchmark import readers


def read(run):
    return readers.family_ms(run, "library conv (cuDNN)")
