"""Milliseconds a step in which no kernel, copy or fill runs on the card
while the host is inside the program's loader or upload ranges
(``meme.loader.*``, ``meme.upload``), in the profiled slice."""
from portbench.phases import idle_in_ms, is_loader


def read(trace):
    return idle_in_ms(trace, is_loader)
