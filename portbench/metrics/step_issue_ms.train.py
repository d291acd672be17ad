"""Host ms to issue one train_step call, from the benchmark's span around
it, in the window."""
from portbench.readers import host_ms


def read(trace):
    return host_ms(trace, ("issue",))
