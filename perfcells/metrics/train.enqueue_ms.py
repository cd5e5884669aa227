"""Mean wall ms of a training step's ``train.step`` span over the traced
chunk's steps: the host's time to draw a step's random numbers, copy them
and the indices into the graph's slots and launch the replay, to read
against the device's step."""

from perfcells import spans as sp

UNIT = "ms"


def read(ctx):
    return sp.mean_ms(sp.program_spans(), "train.step")
