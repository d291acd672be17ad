"""Reductions over the program's named host ranges in the profiled slice.

The port names the phases of its host work with FUNCTION-scope profiler
ranges (``meme_challenge_tpu_torch/train/observability.py: span``):
``meme.loader.order``, ``meme.loader.batch``, ``meme.loader.stack``,
``meme.upload``, ``meme.rng``, ``meme.step`` holding
``meme.step.forward``, ``meme.step.backward`` and ``meme.step.optimizer``,
``meme.eval.forward``, ``meme.eval.fetch``, ``meme.train.fetch``. They are
host events (``kind`` ``cpu``) on the profiler's clock, so a phase is read
by time: a launch call belongs to the range open when it starts, whichever
thread makes it (autograd's device thread launches the backward while the
caller waits inside ``meme.step.backward``), and idle time is the device's
idle intervals intersected with the ranges' intervals.

Every function returns None where the slice holds nothing to read: no
range of the names it reads (a program without the ranges), no launch
call, or no unit. The launch calls' names are the patterns of
``metrics/launch_calls.d/*.txt``.
"""
from __future__ import annotations

import bisect
import os
import re
from typing import Callable, List, Optional

from portbench.tracing import SLICE, Trace, merge

LAUNCH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "metrics", "launch_calls.d")
ON_DEVICE = ("kernel", "memcpy", "memset")


def launch_patterns() -> List[re.Pattern]:
    """One regular expression a line of every file under ``LAUNCH_DIR``,
    matched against a host event's whole name."""
    out = []
    for fname in sorted(os.listdir(LAUNCH_DIR)):
        with open(os.path.join(LAUNCH_DIR, fname)) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    out.append(re.compile(line))
    return out


def host_ranges(t: Trace, pick: Callable[[str], bool]) -> List[tuple]:
    """The merged intervals of the host events whose name ``pick`` takes."""
    return merge([(e.start, e.end) for e in t.events
                  if e.kind == "cpu" and pick(e.name)])


def device_idle(t: Trace) -> List[tuple]:
    """The intervals of the slice in which no kernel, copy or fill runs."""
    lo, hi = t.span
    busy = merge([(max(e.start, lo), min(e.end, hi)) for e in t.events
                  if e.kind in ON_DEVICE and e.end > lo and e.start < hi])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def overlap_us(a: List[tuple], b: List[tuple]) -> float:
    """Microseconds two sorted, merged interval lists share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _readable(t: Trace) -> bool:
    return (t.span is not None and t.slice_units > 0
            and any(e.kind == "kernel" for e in t.events))


def launches_in(t: Trace, name: str) -> Optional[float]:
    """Launch calls a unit that start inside a range named ``name``."""
    if not t.slice_units:
        return None
    ranges = host_ranges(t, lambda n: n == name)
    pats = launch_patterns()
    calls = [e.start for e in t.events if e.kind == "cpu"
             and any(p.fullmatch(e.name) for p in pats)]
    if not ranges or not calls:
        return None
    starts = [a for a, _ in ranges]
    inside = 0
    for c in calls:
        k = bisect.bisect_right(starts, c) - 1
        if k >= 0 and c <= ranges[k][1]:
            inside += 1
    return inside / t.slice_units


def is_loader(name: str) -> bool:
    return name.startswith("meme.loader.") or name == "meme.upload"


def idle_in_ms(t: Trace, pick: Callable[[str], bool]) -> Optional[float]:
    """Milliseconds a unit in which the device is idle and the host is
    inside a range ``pick`` takes."""
    if not _readable(t):
        return None
    ranges = host_ranges(t, pick)
    if not ranges:
        return None
    return overlap_us(device_idle(t), ranges) / 1e3 / t.slice_units


def unnamed_idle_ms(t: Trace) -> Optional[float]:
    """Milliseconds a unit in which the device is idle and no host event
    is open (no program range, torch operation or CUDA API call; the
    benchmark's slice label aside): the idle time the trace puts down to
    nothing."""
    if not _readable(t):
        return None
    host = host_ranges(t, lambda n: n != SLICE)
    idle = device_idle(t)
    total = sum(b - a for a, b in idle) - overlap_us(idle, host)
    return total / 1e3 / t.slice_units
