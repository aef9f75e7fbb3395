"""Device ms a train step in the stage `d_step` of the port's stage
marks: the discriminator's losses, backward and Adam step."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "d_step")
