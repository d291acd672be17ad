"""Device ms an optimizer step of the kernels that compute the detector's
ROIAlign in the profiled slice: the kernels whose name a pattern of
``roi_align_kernels.d/*.txt`` finds (one regular expression a line,
searched in the device kernel's name). With torch's indexing that is the
backward's scatter alone: the forward's gathers share their kernel's name
with the step's other gathers, and the pattern file says why they are left
out."""
import os
import re

PATTERN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "roi_align_kernels.d")


def patterns():
    out = []
    for fname in sorted(os.listdir(PATTERN_DIR)):
        with open(os.path.join(PATTERN_DIR, fname)) as f:
            out += [re.compile(line.strip()) for line in f
                    if line.strip() and not line.startswith("#")]
    return out


def read(trace):
    if not trace.slice_units:
        return None
    pats = patterns()
    us = sum(e.end - e.start for e in trace.events if e.kind == "kernel"
             and any(p.search(e.name) for p in pats))
    return us / 1e3 / trace.slice_units if us else None
