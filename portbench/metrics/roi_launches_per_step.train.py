"""Kernel launch calls an optimizer step that start inside the program's
``meme.det.roi`` ranges (the detector's proposal set, ROIAlign, ROI heads
and their losses), in the profiled slice."""
from portbench.phases import launches_in


def read(trace):
    return launches_in(trace, "meme.det.roi")
