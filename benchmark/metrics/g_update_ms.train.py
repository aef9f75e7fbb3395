"""Device ms a train step in the stage `g_update` of the port's stage
marks: Adam on the generator and the correspondence net, and the EMA."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "g_update")
