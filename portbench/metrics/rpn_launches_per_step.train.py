"""Kernel launch calls an optimizer step that start inside the program's
``meme.det.rpn`` ranges (the detector's anchors, matching, sampling and
RPN losses), in the profiled slice."""
from portbench.phases import launches_in


def read(trace):
    return launches_in(trace, "meme.det.rpn")
