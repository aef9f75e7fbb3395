"""Device ms a forward in the stage `gen` of the port's stage marks: the
SPADE generator and the uint8 quantization."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "gen")
