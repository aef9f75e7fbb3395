"""Device ms a train step in the stage `losses` of the port's stage
marks: the VGG features and the generator's loss terms."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "losses")
