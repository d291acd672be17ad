"""Kernels launched an optimizer step: the device kernels in the profiled
slice over its steps."""
from portbench.readers import launches_per_unit


def read(trace):
    return launches_per_unit(trace)
