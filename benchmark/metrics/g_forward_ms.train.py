"""Device ms a train step in the stages `prep`, `corr` and `gen` of the
port's stage marks: the generator's forward with its preprocessing."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "prep", "corr", "gen")
