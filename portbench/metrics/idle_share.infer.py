"""The share of a unit's wall time in which no kernel runs on the card (%):
the kernels' busy seconds a unit from the trace's timeline, over the
seconds a unit takes in the window."""
from portbench.readers import idle_percent


def read(trace):
    return idle_percent(trace)
