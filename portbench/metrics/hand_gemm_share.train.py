"""The port's hand-written GEMM's share of the profiled optimizer steps'
matrix-product device time (%): kernels named by ``gemm_kernels.d``.
Nothing where the slice ran no hand-written GEMM."""
from portbench.gemm_share import hand_gemm_percent


def read(trace):
    return hand_gemm_percent(trace)
