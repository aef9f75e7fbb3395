"""Median over the traced requests of the host's share of the port's
span `serve.launch` (the serve graph's replay launched): its length less
the time in which the device ran inside it, ms."""

from benchmark import stages


def read(run):
    return stages.span_ms(run, "serve.launch")
