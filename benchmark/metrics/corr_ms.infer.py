"""Device ms a forward in the stage `corr` of the port's stage marks:
the correspondence net, the correlation and the warp."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "corr")
