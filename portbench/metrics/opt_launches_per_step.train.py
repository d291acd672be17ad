"""Kernel launch calls an optimizer step that start inside the program's
``meme.step.optimizer`` ranges, in the profiled slice."""
from portbench.phases import launches_in


def read(trace):
    return launches_in(trace, "meme.step.optimizer")
