"""Milliseconds a step in which the card is idle and no host event is
open in the profiled slice: the idle time nothing in the trace names."""
from portbench.phases import unnamed_idle_ms


def read(trace):
    return unnamed_idle_ms(trace)
