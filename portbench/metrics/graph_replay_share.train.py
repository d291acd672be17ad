"""The share of the profiled slice's optimizer steps that replayed a
captured CUDA graph (%): the program's ``meme.step.replay`` ranges over the
slice's steps. Nothing where the program has no such range."""


def read(trace):
    n = sum(1 for e in trace.events
            if e.kind == "cpu" and e.name == "meme.step.replay")
    return 100.0 * n / trace.slice_units if n and trace.slice_units else None
