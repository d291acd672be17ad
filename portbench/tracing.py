"""What a traced run records, and the reduction of a profiler trace.

- :class:`Spans`: host-clock spans the drivers take around their calls into
  the program (``batch``: the loader and the stacking; ``upload``:
  ``to_device``; ``issue``: one ``train_step`` call), kept in memory. A run
  without tracing holds a :class:`NoSpans`, which records nothing.
- :func:`device_events`: the profiled slice's events, normalised to
  ``Event(name, kind, start_us, end_us)`` with ``kind`` one of ``kernel``,
  ``memcpy``, ``memset`` (on the card) or ``cpu`` (a host operation or a
  ``record_function`` label).
- :class:`Trace`: what a per-layer metric's reader gets (see
  ``metrics/*.py``).
- :func:`union_s`, :func:`breakdown`: busy time, idle gaps and the device
  operations that took most time.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

SLICE = "portbench.slice"


class Spans:
    def __init__(self):
        self.spans: Dict[str, List[float]] = defaultdict(list)

    def timed(self, name: str):
        return _Timed(self.spans[name])


class _Timed:
    __slots__ = ("out", "t0")

    def __init__(self, out: list):
        self.out = out

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.out.append(time.perf_counter() - self.t0)


class NoSpans:
    spans: Dict[str, List[float]] = {}

    def timed(self, name: str):
        return _NULL


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Event(NamedTuple):
    name: str
    kind: str
    start: float  # us
    end: float    # us


def _kind(name: str, on_device: bool) -> str:
    # the benchmark's own labels are mirrored onto the device's timeline
    if not on_device or name.startswith("portbench."):
        return "cpu"
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def device_events(prof) -> List[Event]:
    """The events of a ``torch.profiler.profile`` that has stopped."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        out.append(Event(e.name, _kind(e.name, e.device_type
                                       == DeviceType.CUDA),
                         float(e.time_range.start), float(e.time_range.end)))
    return out


@dataclass
class Trace:
    """The traced run, as the readers see it.

    ``events``: the profiled slice (:class:`Event`); ``span``: the slice's
    ``(start_us, end_us)``; ``slice_units``: optimizer steps (or scoring
    batches) in the slice; ``attention_launches``: the bound in seconds of
    each attention launch in the slice, ``(kind, seconds)`` with kind
    ``fwd`` or ``bwd``; ``spans``: host seconds by span name in the window,
    over its ``units`` steps (or batches); ``flops``, ``seconds``: the model
    FLOPs of the valid tokens the window stepped and its seconds;
    ``peak_flops``: the peak of the cell's dtype; ``attn_patterns``: ``(kind, regex)`` of the
    attention kernels' names."""
    events: List[Event] = field(default_factory=list)
    span: Optional[tuple] = None
    slice_units: int = 0
    attention_launches: List[tuple] = field(default_factory=list)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    units: int = 0
    flops: float = 0.0
    seconds: float = 0.0
    peak_flops: float = 0.0
    attn_patterns: List[tuple] = field(default_factory=list)


def _clip(events, span) -> List[tuple]:
    lo, hi = span
    return sorted((max(e.start, lo), min(e.end, hi)) for e in events
                  if e.end > lo and e.start < hi)


def merge(intervals: List[tuple]) -> List[tuple]:
    """Sorted intervals merged where they overlap."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def union_s(events: List[Event], span: tuple, kinds=("kernel",)) -> float:
    """Seconds of ``span`` in which an event of ``kinds`` ran."""
    merged = merge(_clip([e for e in events if e.kind in kinds], span))
    return sum(b - a for a, b in merged) / 1e6


def _host_label(cpu: List[Event], t: float) -> str:
    """The outermost benchmark label and the innermost host operation
    running at ``t``."""
    around = [e for e in cpu if e.start <= t <= e.end and e.name != SLICE]
    if not around:
        return "no torch op on the host"
    outer = [e.name for e in around if e.name.startswith("portbench.")]
    inner = min(around, key=lambda e: e.end - e.start).name
    return "/".join(([outer[0]] if outer else []) + [inner])


def breakdown(events: List[Event], span: tuple, top: int = 10) -> dict:
    """``device_ops``: the device operations that took most time in the
    slice, in seconds; ``idle_gaps``: the longest gaps between them, summed
    by what the host was doing halfway through each."""
    on_device = [e for e in events if e.kind != "cpu"]
    by_name: Dict[str, float] = defaultdict(float)
    for e in on_device:
        by_name[e.name] += (e.end - e.start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    merged = merge(_clip(on_device, span))
    edges = [span[0]] + [x for iv in merged for x in iv] + [span[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    cpu = [e for e in events if e.kind == "cpu"]
    named: Dict[str, float] = defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top * 4]:
        named[_host_label(cpu, (a + b) / 2)] += (b - a) / 1e6
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def slice_span(events: List[Event]) -> Optional[tuple]:
    for e in events:
        if e.kind == "cpu" and e.name == SLICE:
            return (e.start, e.end)
    return None
