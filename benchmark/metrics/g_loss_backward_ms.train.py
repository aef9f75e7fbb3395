"""Device ms a train step in the stage `loss_backward` of the port's
stage marks: the generator loss's gradient until it reaches the fake image
(the backward through VGG and D)."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "loss_backward")
