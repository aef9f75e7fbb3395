"""Device ms a train step in the elementwise / other kernel family."""

from benchmark import readers


def read(run):
    return readers.family_ms(run, "elementwise / other")
