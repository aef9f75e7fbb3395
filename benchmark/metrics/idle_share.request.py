"""% of the traced segment in which no operation ran on the device."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
