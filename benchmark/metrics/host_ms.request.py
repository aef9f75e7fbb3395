"""Median over the traced requests of the host's share of a request:
its span's length less the time in which the device ran inside it, ms."""

from benchmark import readers


def read(run):
    return readers.host_ms(run, "request")
