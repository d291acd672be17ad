"""The grouped expert kernel's launches in the profiled slice, read by
``metrics/expert_gemm_{roofline,ms}.train.py``: the kernels whose name a
pattern of ``metrics/expert_gemm_kernels.d/*.txt`` finds, and their bounds,
which the driver hands the harness's per-launch bound list under the kind
``expert`` (``drivers/objtext_train.py``)."""
from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

from portbench.tracing import Trace

PATTERN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "metrics", "expert_gemm_kernels.d")


def patterns() -> List["re.Pattern"]:
    out = []
    for fname in sorted(os.listdir(PATTERN_DIR)):
        with open(os.path.join(PATTERN_DIR, fname)) as f:
            out += [re.compile(line.strip()) for line in f
                    if line.strip() and not line.startswith("#")]
    return out


def kernels(t: Trace) -> Tuple[int, float]:
    """(launches, device seconds) of the grouped kernel in the slice."""
    pats = patterns()
    found = [e for e in t.events if e.kind == "kernel"
             and any(p.search(e.name) for p in pats)]
    return len(found), sum(e.end - e.start for e in found) / 1e6


def roofline_percent(t: Trace) -> Optional[float]:
    """Σ bound / Σ device time of the grouped launches, where the kernels
    found are as many as the launches the driver bounded."""
    bounds = [s for kind, s in t.attention_launches if kind == "expert"]
    n, seconds = kernels(t)
    if not bounds or not seconds or n != len(bounds):
        return None
    return 100.0 * sum(bounds) / seconds


def ms_per_unit(t: Trace) -> Optional[float]:
    n, seconds = kernels(t)
    if not n or not t.slice_units:
        return None
    return 1e3 * seconds / t.slice_units
