"""Device ms a train step in the optimizer (Adam, EMA) kernel family."""

from benchmark import readers


def read(run):
    return readers.family_ms(run, "optimizer (Adam, EMA)")
