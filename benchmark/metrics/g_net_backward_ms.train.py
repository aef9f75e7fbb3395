"""Device ms a train step in the stage `net_backward` of the port's
stage marks: the backward of the generator and the correspondence net."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "net_backward")
