"""The fused attention launches' share of their roofline in the profiled
slice, forward and backward together, over valid lengths (%)."""
from portbench.readers import attention_roofline_percent


def read(trace):
    return attention_roofline_percent(trace)
