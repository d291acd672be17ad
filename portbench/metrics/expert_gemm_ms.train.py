"""Device ms an optimizer step of the grouped expert kernel (the held
experts' products, forward and backward) in the profiled slice. Nothing
where the slice ran no such kernel."""
from portbench.expert_gemm import ms_per_unit


def read(trace):
    return ms_per_unit(trace)
