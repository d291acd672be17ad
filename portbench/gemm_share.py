"""The hand-written GEMM's share of the matrix products' device time, read
by ``metrics/hand_gemm_share.{train,infer}.py``."""
from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

from portbench.tracing import Trace

PATTERN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "metrics", "gemm_kernels.d")


def patterns() -> List[Tuple[str, "re.Pattern"]]:
    """(``hand`` or ``library``, regex) of every line under
    ``metrics/gemm_kernels.d``."""
    out = []
    for fname in sorted(os.listdir(PATTERN_DIR)):
        with open(os.path.join(PATTERN_DIR, fname)) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    kind, rx = line.split(None, 1)
                    out.append((kind, re.compile(rx)))
    return out


def hand_gemm_percent(t: Trace) -> Optional[float]:
    """Device time of the slice's kernels that a ``hand`` pattern finds, over
    that of the kernels a ``hand`` or a ``library`` pattern finds, × 100.
    Nothing where no hand-written GEMM ran in the slice."""
    pats = patterns()
    hand = [rx for kind, rx in pats if kind == "hand"]
    library = [rx for kind, rx in pats if kind == "library"]
    us = {"hand": 0.0, "library": 0.0}
    for e in t.events:
        if e.kind != "kernel":
            continue
        if any(rx.search(e.name) for rx in hand):
            us["hand"] += e.end - e.start
        elif any(rx.search(e.name) for rx in library):
            us["library"] += e.end - e.start
    if not us["hand"]:
        return None
    return 100.0 * us["hand"] / (us["hand"] + us["library"])
