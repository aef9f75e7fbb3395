"""GiB: the run's peak of allocated device memory."""

from benchmark import readers


def read(run):
    return readers.peak_gib(run)
