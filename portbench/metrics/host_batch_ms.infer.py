"""Host ms a unit spends getting its batch: the loader (and, where the
benchmark makes the call, the stacking and the upload), from the
benchmark's spans in the window."""
from portbench.readers import host_ms


def read(trace):
    return host_ms(trace, ("batch", "upload"))
