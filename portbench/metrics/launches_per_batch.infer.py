"""Kernels launched a scoring batch: the device kernels in the profiled
slice over its batches."""
from portbench.readers import launches_per_unit


def read(trace):
    return launches_per_unit(trace)
