"""The grouped expert kernel's share of its roofline in the profiled slice
(%): Σ bound over Σ device time of its launches, each launch's bound the
larger of its operations over the float32 peak and its bytes (the held
experts' weights and the rows' inputs and outputs) over the memory's
bandwidth, from the rows the program's counter saw (``flops_moe.py``).
Nothing where the slice ran no such kernel."""
from portbench.expert_gemm import roofline_percent


def read(trace):
    return roofline_percent(trace)
