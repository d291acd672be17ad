"""Reductions the per-layer metrics share (``metrics/<name>.py`` each call
one). Every function returns None where the trace holds nothing to read,
and the harness then leaves the metric out of the result."""
from __future__ import annotations

import re
from typing import Optional

from portbench.tracing import Trace, union_s


def host_ms(t: Trace, names) -> Optional[float]:
    """Host milliseconds a unit (optimizer step or scoring batch) of the
    window spent in the spans ``names``."""
    if not t.units:
        return None
    total = sum(sum(t.spans.get(n, ())) for n in names)
    return 1e3 * total / t.units if total else None


def launches_per_unit(t: Trace) -> Optional[float]:
    """Kernels that ran on the device in the profiled slice, a unit."""
    n = sum(1 for e in t.events if e.kind == "kernel")
    return n / t.slice_units if n and t.slice_units else None


def mfu_percent(t: Trace) -> Optional[float]:
    """Model FLOPs of the valid tokens the window stepped, over its
    seconds, as a share of the peak of the cell's dtype."""
    if not (t.flops and t.seconds and t.peak_flops):
        return None
    return 100.0 * t.flops / t.seconds / t.peak_flops


def idle_percent(t: Trace) -> Optional[float]:
    """The share of a unit's wall time in which no kernel runs: one less
    the seconds a unit keeps a kernel running (the union of the kernels'
    intervals in the profiled slice, a unit) over the seconds a unit takes
    in the window, where the profiler adds no host cost."""
    if (t.span is None or not t.units or not t.slice_units
            or not any(e.kind == "kernel" for e in t.events)):
        return None
    busy = union_s(t.events, t.span) / t.slice_units
    return 100.0 * (1.0 - busy / (t.seconds / t.units))


def attention_roofline_percent(t: Trace) -> Optional[float]:
    """Σ bound / Σ device time of the attention launches in the slice.
    Read only where the kernels matched are as many as the launches the
    slice made (a backward body may take two kernels a launch)."""
    if not t.attention_launches or not t.attn_patterns:
        return None
    pats = [(kind, re.compile(rx)) for kind, rx in t.attn_patterns]
    seconds = {"fwd": 0.0, "bwd": 0.0}
    counts = {"fwd": 0, "bwd": 0}
    for e in t.events:
        if e.kind != "kernel":
            continue
        for kind, rx in pats:
            if rx.search(e.name):
                seconds[kind] += (e.end - e.start) / 1e6
                counts[kind] += 1
                break
    want = {k: sum(1 for kind, _ in t.attention_launches if kind == k)
            for k in ("fwd", "bwd")}
    if counts["fwd"] != want["fwd"] or counts["bwd"] not in (
            want["bwd"], 2 * want["bwd"]):
        return None
    bound = sum(s for _, s in t.attention_launches)
    measured = seconds["fwd"] + seconds["bwd"]
    return 100.0 * bound / measured if measured else None
