"""One run of one cell, driven by the files the cell names.

:func:`resolve` reads ``BENCHMARK.json`` and finds, by name, the cell's
configuration (``configs/<config>.json``), its mix
(``traffic/<traffic>.json``), the driver the mix names
(``drivers/<driver>.py``), its limits (``limits/<cell>.json``) and the
readers of its per-layer metrics (``metrics/<name>.py``). :func:`run` then
makes the set-up, the window and the check, and returns the result line.
Adding a cell, a mix, a configuration or a metric adds files and edits
none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from portbench import flops
from portbench.tracing import (
    SLICE,
    NoSpans,
    Spans,
    Trace,
    breakdown,
    device_events,
    slice_span,
    union_s,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = float(2 ** 30)


@dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]
    chips: int = 1


@dataclass
class Context:
    """What a driver is given."""
    cell: str
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    data_dir: str
    log: Callable[[str], None] = print
    t_start: float = 0.0

    def phase(self, what: str) -> None:
        self.log("%7.3f s  %s" % (time.perf_counter() - self.t_start, what))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _relevant(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def resolve(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files found under
    ``root/portbench``."""
    from portbench import check

    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError("no workload %r in BENCHMARK.json" % name)
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = _load_json(os.path.join(root, conf["file"]))
    traffic = mix(w["traffic"], root)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _relevant(m, name, names)]
    return Cell(name, cfg, traffic, e2e, per_layer,
                check.limits(name, os.path.join(root, "portbench", "limits")),
                w["chips"])


def mix(traffic: str, root: str = ROOT) -> dict:
    """The parameters of the mix ``traffic``."""
    return _load_json(os.path.join(root, "portbench", "traffic",
                                   traffic + ".json"))


def reader(metric: str, root: str = ROOT) -> Callable:
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(root, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def attn_patterns(root: str = ROOT) -> List[tuple]:
    """(``fwd``/``bwd``, regex) of every pattern file under
    ``portbench/metrics/attn_kernels.d``."""
    d = os.path.join(root, "portbench", "metrics", "attn_kernels.d")
    out = []
    for fname in sorted(os.listdir(d)):
        with open(os.path.join(d, fname)) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    kind, rx = line.split(None, 1)
                    out.append((kind, rx))
    return out


def driver(mix: dict):
    return importlib.import_module("portbench.drivers." + mix["driver"])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    units: int = 0
    samples: int = 0
    seconds: float = 0.0
    metas: list = field(default_factory=list)
    trace: Optional[Trace] = None
    breakdown: Optional[dict] = None
    busy_s: float = 0.0
    window_s: float = 0.0


def window(drv, seconds: float, traced: bool, device, peak: dict) -> Window:
    """Units of the driver for ``seconds``, then the one in flight is
    finished and the device synchronised. Traced: the window runs with the
    benchmark's spans, and after it the profiled slice, a few units under
    ``torch.profiler``."""
    w = Window()
    spans = Spans() if traced else NoSpans()
    _sync(device)
    t0 = time.perf_counter()
    while True:
        units, samples, meta = drv.window_unit(spans)
        w.units += units
        w.samples += samples
        w.metas.append(meta)
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    w.seconds = time.perf_counter() - t0
    if not traced:
        return w
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    launches, slice_units = [], 0
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            for _ in range(drv.profiled_units):
                units, _, meta = drv.window_unit(NoSpans())
                slice_units += units
                launches += drv.attention_launches(meta, peak)
            _sync(device)
    events = device_events(prof)
    span = slice_span(events)
    w.trace = Trace(events=events, span=span, slice_units=slice_units,
                    attention_launches=launches, spans=dict(spans.spans),
                    units=w.units,
                    flops=sum(drv.unit_flops(m) for m in w.metas),
                    seconds=w.seconds,
                    peak_flops=peak["flops"][drv.ucfg.dtype],
                    attn_patterns=attn_patterns())
    if span is not None:
        w.breakdown = breakdown(events, span)
        w.window_s = (span[1] - span[0]) / 1e6
        w.busy_s = union_s(events, span, kinds=("kernel", "memcpy", "memset"))
    return w


def _card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return {"nvidia_smi": out[0] if out else ""}
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": "unread (%s)" % e}


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, log: Callable[[str], None] = lambda s: None,
        control: Optional[Callable] = None) -> dict:
    """One run; returns the result line as a dict. ``t_start``: the
    process's start on ``time.perf_counter``. ``control(drv)``, where
    given, runs after the check with the driver's reference still at hand
    (the calibration's controls)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    data_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        ctx = Context(cell.name, cell.cfg, cell.mix, int(seed), device,
                      data_dir, log, t_start)
        drv = driver(cell.mix).Driver(ctx)
        drv.setup()
        _sync(device)
        peak = flops.peaks(torch.cuda.get_device_name(device) if cuda
                           else "H100")
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start
        log("set-up %.3f s" % setup_s)
        w = window(drv, seconds, traced, device, peak)
        window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        log("window %.3f s, %d %s, %d memes" % (w.seconds, w.units,
                                                drv.units, w.samples))
        drv.release()
        numbers = drv.check()
        extra = control(drv) if control is not None else None
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    rate = w.samples / w.seconds
    e2e = {drv.rate_metric: rate, "peak_gib": window_peak / GIB,
           "setup_s": setup_s}
    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(w.trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if traced:
        dev.update(busy_s=w.busy_s, window_s=w.window_s)
    out = {"correct": failed == 0, "attempted": w.units if drv.units ==
           "steps" else w.samples, "failed": failed, "metrics": metrics,
           "device": dev}
    if traced and w.breakdown is not None:
        out["breakdown"] = w.breakdown
    out["card"] = dict(_card() if cuda else {},
                       peaks={"flops": peak["flops"],
                              "bytes_per_s": peak["bytes_per_s"]})
    if extra is not None:
        out["control"] = extra
    out["checks"] = checks
    return out

