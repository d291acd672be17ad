"""Model FLOPs of the valid tokens over the window's seconds, as a share of the peak of the cell's dtype (%)."""
from portbench.readers import mfu_percent


def read(trace):
    return mfu_percent(trace)
